"""Connected components and a simple blob detector (port of
opencv_tpu/ops/ccomp.py; cv::connectedComponents, SimpleBlobDetector).

Labels come from min-label propagation to a fixed point: each sweep
takes the minimum over the neighbours, so a component's labels settle on
its minimum linear index + 1 after as many sweeps as its longest
in-component path. The JAX package tests for change after every sweep
inside a `lax.while_loop`; here the host reads one flag per
`_CHECK_EVERY` sweeps. A sweep at the fixed point changes nothing, so
the sweeps run past it change no label: the result is exact.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.device import resolve_device

_CHECK_EVERY = 16  # sweeps per host read of the convergence flag

_OFFSETS = {
    4: ((-1, 0), (1, 0), (0, -1), (0, 1)),
    8: ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)),
}


class Labels(NamedTuple):
    labels: torch.Tensor  # i32 [H, W]: 0 background, else min linear index + 1
    sweeps: int  # propagation sweeps run
    host_reads: int  # convergence flags read by the host


def connected_components_stats(mask: torch.Tensor, connectivity: int = 8) -> Labels:
    """`connected_components` with the sweeps and host reads it took. A
    mask [..., H, W] labels each image on its own (the labels are the same
    as one image at a time: extra sweeps change nothing)."""
    h, w = mask.shape[-2:]
    dev = mask.device
    big = h * w + 2
    idx = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(h, w)
    labels = torch.where(mask, idx, torch.full_like(idx, big))
    fill = torch.full_like(labels, big)

    def sweep(lab):
        best = lab
        for dy, dx in _OFFSETS[connectivity]:
            best = torch.minimum(best, imgproc.shift2d(lab, dy, dx, fill=big))
        return torch.where(mask, best, fill)

    sweeps = reads = 0
    while True:
        for _ in range(_CHECK_EVERY - 1):
            labels = sweep(labels)
        new = sweep(labels)
        sweeps += _CHECK_EVERY
        reads += 1
        if torch.equal(new, labels):
            break
        labels = new
    return Labels(torch.where(mask, labels, torch.zeros_like(labels)), sweeps, reads)


def connected_components(mask, connectivity: int = 8, device=None) -> torch.Tensor:
    """Label map i32 [H, W] of a bool mask: 0 = background; foreground
    pixels share their component's minimum linear index + 1. Runs on the
    card unless `device="cpu"`."""
    mask = torch.as_tensor(mask, device=resolve_device(device)).to(torch.bool)
    return connected_components_stats(mask, connectivity).labels


class Blobs(NamedTuple):
    xy: torch.Tensor  # [K, 2] centroids
    area: torch.Tensor  # [K]
    circularity: torch.Tensor  # [K] 4 pi area / perimeter^2 proxy
    valid: torch.Tensor  # [K]


def detect_blobs(img, threshold: float = 127.0, dark_blobs: bool = True, min_area: float = 10.0,
                 max_area: float = 5000.0, min_circularity: float = 0.0, max_blobs: int = 64,
                 device=None) -> Blobs:
    """SimpleBlobDetector analog at one threshold: components of the
    dark (or bright) mask, filtered by area and circularity, the largest
    `max_blobs` first. Area, centroid sums and the perimeter count are
    integer-valued f32 scatter-adds, exact while a component's sums stay
    below 2^24. Runs on the card unless `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    dev = img.device
    h, w = img.shape
    mask = (img < threshold) if dark_blobs else (img > threshold)
    flat = connected_components_stats(mask).labels.reshape(-1).to(torch.int64)
    n = h * w + 2
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)
    fg = flat > 0
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    area = zero.index_add(0, flat, fg.to(torch.float32))
    sx = zero.index_add(0, flat, torch.where(fg, xs, 0.0))
    sy = zero.index_add(0, flat, torch.where(fg, ys, 0.0))
    # perimeter proxy: component pixels with a non-member 4-neighbour
    interior = mask
    for dy, dx in _OFFSETS[4]:
        interior = interior & imgproc.shift2d(mask, dy, dx, fill=False)
    edge = (mask & ~interior).reshape(-1)
    perim = zero.index_add(0, flat, edge.to(torch.float32))

    ok = (area >= min_area) & (area <= max_area)
    circ = 4.0 * math.pi * area / torch.clamp(perim * perim, min=1.0)
    ok &= circ >= min_circularity
    idx, keep = masked_top_k(area, ok, max_blobs)
    a = area[idx]
    denom = torch.clamp(a, min=1.0)
    return Blobs(
        xy=torch.stack([sx[idx] / denom, sy[idx] / denom], -1),
        area=torch.where(keep, a, 0.0),
        circularity=torch.where(keep, circ[idx], 0.0),
        valid=keep,
    )
