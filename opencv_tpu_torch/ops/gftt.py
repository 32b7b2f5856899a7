"""goodFeaturesToTrack: Shi-Tomasi / Harris corner selection (port of
opencv_tpu/ops/gftt.py).

The JAX package replaces the reference's sequential greedy min-distance
pass with grid-cell suppression: each corner is rounded to a
min_distance-sized cell and only the strongest corner of a cell survives
(argmax per cell, the first maximum on ties, as `jnp.argmax`), then the
cell winners are culled by a stable top-k. The port keeps that rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import KeyPoints, masked_top_k
from opencv_tpu_torch.device import resolve_device


def good_features_to_track(
    img,
    max_corners: int = 1000,
    quality_level: float = 0.01,
    min_distance: float = 10.0,
    block_size: int = 3,
    use_harris: bool = False,
    harris_k: float = 0.04,
    device=None,
) -> KeyPoints:
    """Corners of a gray image [H, W] as a KeyPoints record of capacity
    `max_corners` (`valid` marks the found ones, strongest first). Runs on
    the card unless `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    dev = img.device
    h, w = img.shape
    if use_harris:
        resp = imgproc.harris_response(img, block_size, harris_k, deriv="sobel",
                                        xla_order=True)
    else:
        resp = imgproc.min_eig_response(img, block_size)
    peak = imgproc.nms_2d(resp)
    good = peak & (resp > quality_level * resp.max())
    neg_inf = torch.tensor(-float("inf"), device=dev)

    if min_distance >= 1.0:
        cell = max(int(min_distance), 1)
        ncy = (h + cell - 1) // cell
        ncx = (w + cell - 1) // cell
        masked = torch.where(good, resp, neg_inf)
        padded = F.pad(masked, (0, ncx * cell - w, 0, ncy * cell - h), value=-float("inf"))
        blocks = padded.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
        blocks = blocks.reshape(ncy * ncx, cell * cell)
        cell_val = blocks.amax(dim=1)
        cell_arg = blocks.argmax(dim=1)  # first maximum, as jnp.argmax
        cid = torch.arange(ncy * ncx, device=dev)
        ys_all = (cid // ncx) * cell + cell_arg // cell
        xs_all = (cid % ncx) * cell + cell_arg % cell
        cand_valid = torch.isfinite(cell_val)
        # a coarse grid can have fewer cells than max_corners: top-k over
        # the cells, then pad back out to the [max_corners] record
        k = min(max_corners, ncy * ncx)
        cidx, keep = masked_top_k(torch.where(cand_valid, cell_val, neg_inf), cand_valid, k)
        pad = max_corners - k
        cidx = torch.cat([cidx, cidx.new_zeros(pad)])
        keep = torch.cat([keep, keep.new_zeros(pad)])
        ys = ys_all[cidx].to(torch.float32)
        xs = xs_all[cidx].to(torch.float32)
        response = torch.where(keep, cell_val[cidx], neg_inf)
    else:
        idx, keep = masked_top_k(torch.where(good, resp, neg_inf).reshape(-1),
                                 good.reshape(-1), max_corners)
        ys = (idx // w).to(torch.float32)
        xs = (idx % w).to(torch.float32)
        response = torch.where(keep, resp.reshape(-1)[idx], neg_inf)

    return KeyPoints(
        xy=torch.stack([xs, ys], dim=-1),
        response=response,
        angle=torch.zeros_like(xs),
        level=torch.zeros(xs.shape, dtype=torch.int32, device=dev),
        size=torch.full(xs.shape, float(block_size), dtype=torch.float32, device=dev),
        valid=keep,
    )
