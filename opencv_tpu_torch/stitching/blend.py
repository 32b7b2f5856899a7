"""Blending (port of opencv_tpu/stitching/blend.py; reference
stitching/src/blenders.cpp): feather and multi-band (Laplacian pyramid)
blending of warped, mask-carrying images.

`distance_weight` is erosions and integer-valued adds: exact. The blends
are the JAX functions' arithmetic in their order.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import pyramid
from opencv_tpu_torch.ops import morphology


def distance_weight(mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Approximate distance-to-border weights by iterated erosion
    accumulation (the feather blender's distanceTransform role)."""
    w = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    cur = mask.to(torch.float32)
    for _ in range(iters):
        w = w + cur
        cur = morphology.erode(cur, 3) * (cur > 0)
        cur = cur.clamp(min=0.0)
    return w


def feather_blend(images: list[torch.Tensor], masks: list[torch.Tensor],
                  sharpness_iters: int = 32) -> torch.Tensor:
    """FeatherBlender analog: weights ~ distance to each mask's border."""
    ws = [distance_weight(m, sharpness_iters) for m in masks]
    wsum = sum(ws)
    acc = sum(w * img.to(torch.float32) for w, img in zip(ws, images))
    return acc / wsum.clamp(min=1e-9)


def _gaussian_pyr(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    levels = [x]
    for _ in range(n - 1):
        levels.append(pyramid.pyr_down(levels[-1]))
    return levels


def _laplacian_pyr(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    g = _gaussian_pyr(x, n)
    lap = []
    for i in range(n - 1):
        h, w = g[i].shape
        lap.append(g[i] - pyramid.pyr_up(g[i + 1])[:h, :w])
    lap.append(g[-1])
    return lap


def multiband_blend(images: list[torch.Tensor], masks: list[torch.Tensor],
                    n_bands: int = 4) -> torch.Tensor:
    """MultiBandBlender analog: blend Laplacian pyramids with Gaussian-
    pyramid weights, collapse."""
    ws = [distance_weight(m, 32) for m in masks]
    wsum = sum(ws)
    ws = [w / wsum.clamp(min=1e-9) for w in ws]

    blended = None
    for img, w in zip(images, ws):
        lp = _laplacian_pyr(img.to(torch.float32), n_bands)
        wp = _gaussian_pyr(w, n_bands)
        terms = [l * wl for l, wl in zip(lp, wp)]
        blended = terms if blended is None else [b + t for b, t in zip(blended, terms)]

    out = blended[-1]
    for i in range(n_bands - 2, -1, -1):
        h, w = blended[i].shape
        out = pyramid.pyr_up(out)[:h, :w] + blended[i]
    return out
