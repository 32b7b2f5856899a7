"""Hough transforms: lines, segments, circles and the generalized
transform (port of opencv_tpu/ops/hough.py).

Reference: cv::HoughLines / HoughLinesP (imgproc/src/hough.cpp:108,462),
the GPU pipeline of the fork's lane-detection sample
(cuda::HoughSegmentDetector, cudaimgproc/src/cuda/hough_segments.cu;
samples/gpu/lane_detection.cpp:244), HoughCircles and
GeneralizedHoughBallard.

The JAX design is kept: a dense [n_theta, n_rho] vote accumulator; the
segment detector walks each of the top-K peak lines at a fixed sampling,
closes gaps with a 1-D morphological pass and keeps the longest run.
What changes:
- Votes are integer counts, so one `index_add_` over the edge pixels
  alone gives the accumulator the JAX code builds with a bincount per
  theta over every pixel (whose non-edge votes add 0.0): exact in any
  order, and never the dense [n_theta, H*W] index array (221 MB at
  480x640).
- The longest run, a `lax.scan` in JAX, is a cumulative maximum of the
  last gap's position; `argmax` takes the first maximum in both.
- Every transcendental (the theta table's cos/sin, atan2, sqrt) is taken
  in f64 and rounded to f32, so the card and the CPU give the same bits.
  XLA's f32 cos/sin are not always correctly rounded (a few of the 180
  thetas differ by an ulp), so a pixel whose rho lies within an ulp of a
  bin edge can vote one bin over from the JAX accumulator.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.ops.edges import canny

F32 = torch.float32


def _f32(fn, *args: torch.Tensor) -> torch.Tensor:
    """fn evaluated in f64 and rounded to f32: correctly rounded (but for
    double rounding) on every device."""
    return fn(*(a.double() for a in args)).to(F32)


def _edge_points(edges: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat index, x f32, y f32) of the edge pixels of a [H, W] mask,
    row-major (one host sync: the count)."""
    w = edges.shape[1]
    sel = torch.nonzero(edges.reshape(-1))[:, 0]
    return sel, (sel % w).to(F32), (sel // w).to(F32)


def hough_lines_accumulator(
    edges: torch.Tensor, rho_res: float = 1.0, theta_res: float = math.pi / 180.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense vote accumulator. Returns (acc [n_theta, n_rho] f32, thetas,
    rhos), on the mask's device."""
    h, w = edges.shape
    dev = edges.device
    diag = math.hypot(h, w)
    n_rho = int(2 * math.ceil(diag / rho_res)) + 1
    n_theta = int(round(math.pi / theta_res))
    thetas = torch.arange(n_theta, dtype=F32, device=dev) * theta_res
    rho_off = (n_rho - 1) / 2

    _, xs, ys = _edge_points(edges)
    c, s = _f32(torch.cos, thetas), _f32(torch.sin, thetas)
    rho = xs[None, :] * c[:, None] + ys[None, :] * s[:, None]  # [n_theta, E]
    idx = torch.round(rho / rho_res + rho_off).to(torch.int64).clamp(0, n_rho - 1)
    flat = idx + n_rho * torch.arange(n_theta, device=dev)[:, None]
    acc = torch.zeros(n_theta * n_rho, dtype=F32, device=dev)
    acc.index_add_(0, flat.reshape(-1), torch.ones(flat.numel(), dtype=F32, device=dev))
    rhos = (torch.arange(n_rho, dtype=F32, device=dev) - rho_off) * rho_res
    return acc.reshape(n_theta, n_rho), thetas, rhos


def hough_lines(
    edges: torch.Tensor,
    threshold: float,
    max_lines: int = 32,
    rho_res: float = 1.0,
    theta_res: float = math.pi / 180.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K (rho, theta) line peaks with 3x3 accumulator NMS.
    Returns (lines [K, 2] as (rho, theta), valid [K])."""
    acc, thetas, rhos = hough_lines_accumulator(edges, rho_res, theta_res)
    peak = imgproc.nms_2d(acc) & (acc > threshold)
    idx, keep = masked_top_k(acc.reshape(-1), peak.reshape(-1), max_lines)
    n_rho = rhos.shape[0]
    lines = torch.stack([rhos[idx % n_rho], thetas[idx // n_rho]], dim=-1)
    return lines, keep


class Segments(NamedTuple):
    xyxy: torch.Tensor  # [K, 4] (x0, y0, x1, y1)
    valid: torch.Tensor  # [K]


def hough_segments(
    edges: torch.Tensor,
    threshold: float = 30.0,
    min_line_length: int = 20,
    max_line_gap: int = 4,
    max_lines: int = 32,
    rho_res: float = 1.0,
    theta_res: float = math.pi / 180.0,
) -> Segments:
    """Line segments (HoughSegmentDetector analog): march along each peak
    line, bridge gaps <= max_line_gap, keep the longest run if it is at
    least min_line_length samples long. All K lines at once."""
    h, w = edges.shape
    dev = edges.device
    lines, lvalid = hough_lines(edges, threshold, max_lines, rho_res, theta_res)
    # points on a line lie within +/- diag of its foot point
    diag = int(math.ceil(math.hypot(h, w)))
    ts = torch.arange(2 * diag + 1, dtype=F32, device=dev) - diag
    rho, theta = lines[:, 0:1], lines[:, 1:2]
    c, s = _f32(torch.cos, theta), _f32(torch.sin, theta)
    xs = rho * c - ts * s  # [K, T]: foot point + t * (-sin, cos)
    ys = rho * s + ts * c
    inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    xi = torch.round(xs).to(torch.int64).clamp(0, w - 1)
    yi = torch.round(ys).to(torch.int64).clamp(0, h - 1)
    # tolerate 1 px off the line: OR over the 3x3 neighbourhood of a sample
    hit = torch.zeros_like(inside)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            hit |= edges[(yi + dy).clamp(0, h - 1), (xi + dx).clamp(0, w - 1)]
    ok = lvalid[:, None]
    hit &= inside & ok
    # close gaps: dilate, then erode, by max_line_gap along t (cyclic, as jnp.roll)
    closed = hit
    for _ in range(max_line_gap):
        closed = closed | torch.roll(closed, 1, -1) | torch.roll(closed, -1, -1)
    for _ in range(max_line_gap):
        closed = closed & torch.roll(closed, 1, -1) & torch.roll(closed, -1, -1)
    closed &= inside & ok
    # run[t] = t - (last t' <= t with closed[t'] false), or 0 where closed[t] is false
    t_idx = torch.arange(ts.shape[0], device=dev).expand_as(closed)
    last_gap = torch.cummax(torch.where(closed, -1, t_idx), dim=-1).values
    runs = torch.where(closed, t_idx - last_gap, 0)
    end = torch.argmax(runs, dim=-1, keepdim=True)  # the first maximum
    length = runs.gather(-1, end)
    start = end - length + 1
    seg = torch.cat([xs.gather(-1, start), ys.gather(-1, start),
                     xs.gather(-1, end), ys.gather(-1, end)], dim=-1)
    return Segments(xyxy=seg, valid=(length[:, 0] >= min_line_length) & lvalid)


# ------------------------------------------------------------- circles ---

class Circles(NamedTuple):
    xyr: torch.Tensor  # [K, 3] (cx, cy, r)
    votes: torch.Tensor  # [K] center accumulator support
    valid: torch.Tensor  # [K]


def _pixel_index(cx: torch.Tensor, cy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Flat index of the pixel nearest (cx, cy), clamped into the image:
    the JAX code's f32 arithmetic, exact below 2**24."""
    return (torch.round(cy).clamp(0, h - 1) * w + torch.round(cx).clamp(0, w - 1)).to(torch.int64)


def hough_circles(
    img: torch.Tensor,
    min_radius: int = 5,
    max_radius: int = 40,
    radius_step: int = 1,
    canny_threshold: float = 100.0,
    acc_threshold: float = 18.0,
    min_dist: int = 10,
    max_circles: int = 32,
) -> Circles:
    """HOUGH_GRADIENT circle detection (cv::HoughCircles): every edge pixel
    votes for centres along +/- its gradient at each radius of the ladder;
    then each centre candidate's radius is the mode of its distance
    histogram over the edge pixels."""
    img = img.to(F32)
    h, w = img.shape
    dev = img.device
    e = canny(img, canny_threshold * 0.5, canny_threshold)
    gx, gy = imgproc.sobel_derivatives(img)
    sel, xs, ys = _edge_points(e)
    ex, ey = gx.reshape(-1)[sel], gy.reshape(-1)[sel]
    inv = 1.0 / _f32(torch.sqrt, ex * ex + ey * ey).clamp(min=1e-6)
    cf, sf = ex * inv, ey * inv

    radii = list(range(min_radius, max_radius + 1, radius_step))
    acc = torch.zeros(h * w, dtype=F32, device=dev)
    for r in radii:
        for sgn in (1.0, -1.0):
            cx = xs + sgn * r * cf
            cy = ys + sgn * r * sf
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            acc.index_add_(0, _pixel_index(cx, cy, h, w), inside.to(F32))
    acc2d = acc.reshape(h, w)
    peak = imgproc.nms_2d(acc2d, radius=max(1, min_dist // 2)) & (acc2d > acc_threshold)
    idx, keep = masked_top_k(acc, peak.reshape(-1), max_circles)
    cys = (idx // w).to(F32)
    cxs = (idx % w).to(F32)

    # per-candidate radius histogram over the edge pixels, one flat add
    n_bins = len(radii)
    d = _f32(torch.sqrt, (xs[None] - cxs[:, None]) ** 2 + (ys[None] - cys[:, None]) ** 2)
    b = torch.round((d - float(min_radius)) / radius_step).to(torch.int64)
    ok = (b >= 0) & (b < n_bins)
    flat = b.clamp(0, n_bins - 1) + n_bins * torch.arange(len(cxs), device=dev)[:, None]
    hist = torch.zeros(len(cxs) * n_bins, dtype=F32, device=dev)
    hist.index_add_(0, flat.reshape(-1), ok.reshape(-1).to(F32))
    hist = hist.reshape(len(cxs), n_bins)
    bi = torch.argmax(hist, dim=1)
    rads = float(min_radius) + bi.to(F32) * radius_step
    support = hist.gather(1, bi[:, None])[:, 0]
    return Circles(xyr=torch.stack([cxs, cys, rads], dim=-1),
                   votes=torch.where(keep, acc[idx], 0.0),
                   valid=keep & (support > acc_threshold))


# -------------------------------------------------- generalized Hough ---

class GHoughTable(NamedTuple):
    """Ballard R-table: displacement vectors from edge points to the
    template's reference point, binned by gradient orientation."""
    disp: torch.Tensor  # [n_bins, cap, 2] (dx, dy)
    count: torch.Tensor  # [n_bins] valid entries per bin
    n_bins: int


def _orientation_bin(ang: torch.Tensor, a: float, n_bins: int) -> torch.Tensor:
    """Bin of gradient angle `ang` (rad) less rotation `a` among n_bins
    over [-pi, pi), in the JAX code's f32 arithmetic."""
    pos = torch.floor((ang - a + math.pi) / (2 * math.pi) * n_bins).to(torch.int32)
    return torch.remainder(pos, n_bins).to(torch.int64)


def build_r_table(
    template: torch.Tensor,
    canny_threshold: float = 100.0,
    n_bins: int = 32,
    cap: int = 64,
) -> GHoughTable:
    """R-table of a template image (GeneralizedHoughBallard::setTemplate);
    the reference point is the template's centre. Each bin keeps its
    `cap` strongest edge pixels."""
    t = template.to(F32)
    th, tw = t.shape
    dev = t.device
    e = canny(t, canny_threshold * 0.5, canny_threshold).reshape(-1)
    gx, gy = imgproc.sobel_derivatives(t)
    binidx = _orientation_bin(_f32(torch.atan2, gy, gx), 0.0, n_bins).reshape(-1)
    yy, xx = torch.meshgrid(torch.arange(th, dtype=F32, device=dev),
                            torch.arange(tw, dtype=F32, device=dev), indexing="ij")
    dxy = torch.stack([((tw - 1) / 2.0 - xx).reshape(-1), ((th - 1) / 2.0 - yy).reshape(-1)], -1)
    mag = _f32(torch.sqrt, gx * gx + gy * gy).reshape(-1)
    disp, count = [], []
    for b in range(n_bins):
        idx, keep = masked_top_k(mag, e & (binidx == b), cap)
        disp.append(dxy[idx] * keep[:, None].to(F32))
        count.append(keep.sum())
    return GHoughTable(disp=torch.stack(disp), count=torch.stack(count).to(torch.int32),
                       n_bins=n_bins)


class GHoughDetections(NamedTuple):
    xy: torch.Tensor  # [K, 2] detected reference points
    votes: torch.Tensor  # [K]
    angle: torch.Tensor  # [K] best template rotation (rad)
    scale: torch.Tensor  # [K]
    valid: torch.Tensor  # [K]


def generalized_hough(
    img: torch.Tensor,
    table: GHoughTable,
    canny_threshold: float = 100.0,
    vote_threshold: float = 30.0,
    max_detections: int = 8,
    min_dist: int = 16,
    max_edge_points: int = 4096,
    angles: tuple[float, ...] = (0.0,),
    scales: tuple[float, ...] = (1.0,),
) -> GHoughDetections:
    """Generalized Hough detection (GeneralizedHoughBallard::detect; over
    an angle and scale grid, the Guil position + rotation + scale
    variant): the `max_edge_points` strongest edge pixels vote through the
    R-table, one flat add per (angle, scale) cell, and each pixel keeps
    its best cell."""
    img = img.to(F32)
    h, w = img.shape
    dev = img.device
    e = canny(img, canny_threshold * 0.5, canny_threshold)
    gx, gy = imgproc.sobel_derivatives(img)
    mag = _f32(torch.sqrt, gx * gx + gy * gy).reshape(-1)
    ang = _f32(torch.atan2, gy, gx).reshape(-1)
    idx, keep = masked_top_k(mag, e.reshape(-1), max_edge_points)
    px = (idx % w).to(F32)[:, None]
    py = (idx // w).to(F32)[:, None]
    pang = ang[idx]

    slot = torch.arange(table.disp.shape[1], device=dev)
    best_acc = best_a = best_s = None
    for a in angles:
        # cos/sin of the f32 angle, as jnp.cos(a) takes it
        a32 = float(np.float32(a))
        ca, sa = float(np.float32(math.cos(a32))), float(np.float32(math.sin(a32)))
        for s in scales:
            b = _orientation_bin(pang, a, table.n_bins)
            d = table.disp[b]  # [P, cap, 2]
            dxr = s * (ca * d[..., 0] - sa * d[..., 1])
            dyr = s * (sa * d[..., 0] + ca * d[..., 1])
            okslot = slot[None, :] < table.count[b][:, None]
            cx, cy = px + dxr, py + dyr
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1) & okslot & keep[:, None]
            acc = torch.zeros(h * w, dtype=F32, device=dev)
            acc.index_add_(0, _pixel_index(cx, cy, h, w).reshape(-1), inside.reshape(-1).to(F32))
            # light 3x3 smoothing so votes off by one pixel still stack
            acc2 = imgproc.box_filter(acc.reshape(h, w), 3) * 9.0
            if best_acc is None:
                best_acc, best_a, best_s = acc2, torch.full_like(acc2, a), torch.full_like(acc2, s)
            else:
                better = acc2 > best_acc
                best_acc = torch.where(better, acc2, best_acc)
                best_a = torch.where(better, a, best_a)
                best_s = torch.where(better, s, best_s)

    peak = imgproc.nms_2d(best_acc, radius=max(1, min_dist // 2)) & (best_acc > vote_threshold)
    fidx, fkeep = masked_top_k(best_acc.reshape(-1), peak.reshape(-1), max_detections)
    return GHoughDetections(
        xy=torch.stack([(fidx % w).to(F32), (fidx // w).to(F32)], -1),
        votes=torch.where(fkeep, best_acc.reshape(-1)[fidx], 0.0),
        angle=best_a.reshape(-1)[fidx],
        scale=best_s.reshape(-1)[fidx],
        valid=fkeep,
    )
