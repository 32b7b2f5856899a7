"""Marker-based watershed segmentation (port of opencv_tpu/ops/watershed.py;
reference modules/imgproc/src/segmentation.cpp cv::watershed).

The topographic-distance watershed of the JAX package: every pixel takes
the label of the marker reachable with the smallest minimax edge cost,
the Bellman-Ford fixed point of dist[p] = min_q max(dist[q], cost(q, p))
over the 4 neighbours, ties toward the smaller label. The JAX function
relaxes in a `lax.while_loop` until a sweep changes nothing; here the host
reads the change flag once per `_CHECK_EVERY` sweeps. A sweep at the fixed
point changes nothing, so labels, distances and dams equal the JAX
function's (min, max and comparisons only: exact); the loop still ends at
exactly `max_sweeps`. Output: labels, -1 on the dams between basins, as
cv2.watershed codes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.graphcut import _DIRS, _shift

_INF = 3.4e38  # a Python float: no device work at import
_CHECK_EVERY = 16  # sweeps per host read of the change flag


class Watershed(NamedTuple):
    labels: torch.Tensor  # i32 [H, W], -1 on dams
    sweeps: int  # relaxation sweeps until one changed nothing (the JAX loop's count)
    host_reads: int


def watershed_stats(img, markers, max_sweeps: int = 4096, device=None) -> Watershed:
    """`watershed` with its sweep count and host reads."""
    dev = resolve_device(device)
    img = torch.as_tensor(img, device=dev).to(torch.float32)
    chw = img.permute(2, 0, 1) if img.ndim == 3 else img[None]
    markers = torch.as_tensor(markers, device=dev).to(torch.int32)
    h, w = markers.shape

    # edge cost into a pixel: the max channel difference to the neighbour
    costs = [(chw - _shift(chw, dy, dx, _INF)).abs().amax(0) for dy, dx in _DIRS]

    seeded = markers > 0
    dist = torch.where(seeded, 0.0, _INF)
    lab = torch.where(seeded, markers, 0)

    def sweep(dist, lab):
        nd, nl = dist, lab
        for k, (dy, dx) in enumerate(_DIRS):
            q_dist = _shift(dist, dy, dx, _INF)
            q_lab = _shift(lab, dy, dx, 0)
            cand = torch.maximum(q_dist, costs[k])
            better = (cand < nd) | ((cand == nd) & (q_lab > 0) & ((nl == 0) | (q_lab < nl)))
            nd = torch.where(better, cand, nd)
            nl = torch.where(better, q_lab, nl)
        nd = torch.where(seeded, 0.0, nd)  # seeds never change
        nl = torch.where(seeded, markers, nl)
        return nd, nl, (nl != lab).any() | (nd != dist).any()

    changed = torch.ones((), dtype=torch.bool, device=dev)
    sweeps = torch.zeros((), dtype=torch.int32, device=dev)
    run = reads = 0
    while run < max_sweeps:
        for _ in range(min(_CHECK_EVERY, max_sweeps - run)):
            sweeps = sweeps + changed.to(torch.int32)
            dist, lab, changed = sweep(dist, lab)
            run += 1
        reads += 1
        if not bool(changed):
            break

    # dams: a pixel with a 4-neighbour in another basin flooded no later
    # (the reference marks the later side where two labels meet); the
    # seeds and the image border stay as they are
    dam = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for dy, dx in _DIRS:
        q_lab = _shift(lab, dy, dx, 0)
        q_dist = _shift(dist, dy, dx, _INF)
        dam |= (q_lab > 0) & (lab > 0) & (q_lab != lab) & (q_dist <= dist)
    dam &= ~seeded
    return Watershed(torch.where(dam, -1, lab).to(torch.int32), int(sweeps), reads)


def watershed(img, markers, max_sweeps: int = 4096, device=None) -> torch.Tensor:
    """img: [H, W] (gray) or [H, W, 3]; markers: [H, W] int, > 0 seed
    labels, 0 unknown. Returns i32 labels with -1 on the dams, on the
    device. Runs on the card unless `device="cpu"`."""
    return watershed_stats(img, markers, max_sweeps, device).labels
