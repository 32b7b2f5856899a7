"""MSER, maximally stable extremal regions (port of opencv_tpu/ops/mser.py;
reference features2d/src/mser.cpp).

The JAX package's formulation: the component tree's levels are the
thresholded masks {p : img(p) <= t} on a ladder of gray levels; each
level is labelled by min-label connected components (4-connectivity) and
every pixel reads its component's size. Stability
var = (|R(t + delta)| - |R(t - delta)|) / |R(t)| is then elementwise over
the [L, H, W] size stack, a region is the canonical (minimum-index) pixel
of a component at a level where var is a local minimum, and regions are
chosen by masked top-k with a diversity prune (mser.py:61-173).

The JAX function labels the 64 levels one after another in a `lax.scan`
(mser.py:43-59); here `ops/ccomp.py` labels them all at once. Labels are
each component's minimum linear index + 1 whatever the number of sweeps,
so they are the same. Sizes, centroid sums and boxes are integer sums:
the regions equal the JAX function's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.ccomp import connected_components_stats


class MSERRegions(NamedTuple):
    xy: torch.Tensor  # [K, 2] region centroids (x, y)
    area: torch.Tensor  # [K]
    bbox: torch.Tensor  # [K, 4] (x0, y0, x1, y1) inclusive
    threshold: torch.Tensor  # [K] gray level at which the region was taken
    stability: torch.Tensor  # [K] variation (lower = more stable)
    valid: torch.Tensor  # [K] bool


def _level_stack(img: torch.Tensor, thresholds: torch.Tensor):
    """(labels i32 [L, H, W], per-pixel component sizes f32 [L, H, W]) of
    the extremal sets {p : img(p) <= t}; background pixels have size 0."""
    nlev = thresholds.shape[0]
    h, w = img.shape
    labels = connected_components_stats(img[None] <= thresholds[:, None, None], 4).labels
    flat = labels.reshape(nlev, -1).to(torch.int64)
    area = torch.zeros((nlev, h * w + 2), dtype=torch.float32, device=img.device)
    area.scatter_add_(1, flat, (flat > 0).to(torch.float32))
    return labels, torch.gather(area, 1, flat).reshape(nlev, h, w)


def mser_detect(
    img,
    max_regions: int = 64,
    delta: int = 5,
    min_area: float = 60.0,
    max_area: float = 14400.0,
    max_variation: float = 0.25,
    min_diversity: float = 0.2,
    dark_on_bright: bool = True,
    level_step: int = 4,
    device=None,
) -> MSERRegions:
    """cv::MSER::detectRegions analog (MSER::create's defaults: delta 5,
    min_area 60, max_area 14400, max_variation .25, min_diversity .2).
    `dark_on_bright=False` runs MSER+ on the inverted image; `level_step`
    is the gray-level stride of the threshold ladder. Runs on the card
    unless `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    dev = img.device
    if not dark_on_bright:
        img = 255.0 - img
    h, w = img.shape
    thresholds = torch.arange(0, 256, level_step, dtype=torch.float32, device=dev)
    nlev = thresholds.shape[0]
    dlev = max(1, round(delta / level_step))
    labels, sizes = _level_stack(img, thresholds)

    up = torch.cat([sizes[dlev:], sizes[-1:].expand(dlev, h, w)], 0)
    dn = torch.cat([sizes[:1].expand(dlev, h, w), sizes[:-dlev]], 0)
    var = (up - dn) / torch.clamp(sizes, min=1.0)

    idx = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(h, w)
    rep = labels == idx[None]
    big = torch.full_like(var[:1], 1e9)
    var_p = torch.where(rep, var, big)
    above = torch.cat([big, var_p[:-1]], 0)
    below = torch.cat([var_p[1:], big], 0)
    ok = (rep & (var_p <= above) & (var_p <= below) & (var < max_variation)
          & (sizes >= min_area) & (sizes <= max_area))

    # over-select, then prune nested same-seed regions at nearby levels
    k0 = max_regions * 4
    flat_var = var.reshape(-1)
    cand, keep = masked_top_k(-flat_var, ok.reshape(-1), k0)
    lev = cand // (h * w)
    pix = cand % (h * w)
    seed = labels.reshape(nlev, -1)[lev, pix]
    carea = sizes.reshape(nlev, -1)[lev, pix]
    cvar = flat_var[cand]
    k0 = cand.shape[0]
    order = torch.arange(k0, device=dev)
    same = (seed[:, None] == seed[None, :]) & keep[:, None] & keep[None, :]
    better = (cvar[None, :] < cvar[:, None]) | (
        (cvar[None, :] == cvar[:, None]) & (order[None, :] < order[:, None]))
    close = (torch.abs(carea[:, None] - carea[None, :])
             / torch.clamp(torch.maximum(carea[:, None], carea[None, :]), min=1.0)) < min_diversity
    keep &= ~(same & better & close).any(dim=1)

    sel, kept = masked_top_k(-cvar, keep, max_regions)
    lev, pix, cvar = lev[sel], pix[sel], cvar[sel]

    # per-winner component statistics: integer sums, exact
    flat_labels = labels.reshape(nlev, -1)
    lab = flat_labels[lev, pix]
    m = (flat_labels[lev] == lab[:, None]) & (lab[:, None] > 0)  # [K, H*W]
    ys = torch.arange(h, device=dev)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, device=dev)[None, :].expand(h, w).reshape(-1)
    a = m.sum(1)
    denom = torch.clamp(a, min=1).to(torch.float32)
    cx = torch.where(m, xs, 0).sum(1).to(torch.float32) / denom
    cy = torch.where(m, ys, 0).sum(1).to(torch.float32) / denom
    inf = float("inf")
    xsf, ysf = xs.to(torch.float32), ys.to(torch.float32)
    bbox = torch.stack([torch.where(m, xsf, inf).amin(1), torch.where(m, ysf, inf).amin(1),
                        torch.where(m, xsf, -inf).amax(1), torch.where(m, ysf, -inf).amax(1)], -1)
    area = a.to(torch.float32)
    return MSERRegions(
        xy=torch.stack([cx, cy], -1),
        area=torch.where(kept, area, 0.0),
        bbox=bbox,
        threshold=thresholds[lev],
        stability=torch.where(kept, cvar, inf),
        valid=kept & (area >= min_area),
    )
