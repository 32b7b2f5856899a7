"""Histogram back-projection, meanShift and CamShift tracking (port of
opencv_tpu/ops/camshift.py; reference modules/video/src/camshift.cpp:44
meanShift, :110 CamShift; imgproc/src/histogram.cpp:1519 calcBackProject).

The moment integral images (S, S·x, S·y, and the second orders for
CamShift) are built once per frame by two prefix sums in XLA's CPU order
(`imgproc._block_scan`: f32 adds only, so the card, the CPU and eager JAX
give the same bits), and each mean-shift step reads four corners of
them. A step rounds the centroid to an integer window, so one ulp could
move the window: hence the XLA order. The JAX package runs the steps in
a `lax.while_loop`; here the host reads the three window sums once per
step and does the step's f32 arithmetic in numpy, stopping at exactly the
JAX loop's iteration. CamShift's orientation and size are f32 numpy on
the six window sums of the converged window (one host read): numpy's
f32 trig can differ from XLA's by an ulp, so boxes agree with the JAX
package to a tolerance and windows exactly.

Histograms count bins with `bincount` (integers: exact on either device),
then apply the density scale.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device

_f32 = np.float32


def _bin_indices(channel: torch.Tensor, n_bins: int, lo: float, hi: float):
    """cv2 uniform binning: idx = floor((v - lo) * n / (hi - lo)), valid
    only inside [lo, hi)."""
    v = channel.to(torch.float32)
    idx = torch.floor((v - lo) * (n_bins / (hi - lo))).to(torch.int64)
    return idx.clamp(0, n_bins - 1), (v >= lo) & (v < hi)


def _flat_bins(channels, bins, ranges):
    flat = torch.zeros(channels[0].shape, dtype=torch.int64, device=channels[0].device)
    ok = torch.ones(channels[0].shape, dtype=torch.bool, device=channels[0].device)
    stride = 1
    for ch, nb, (lo, hi) in reversed(list(zip(channels, bins, ranges))):
        idx, good = _bin_indices(ch, nb, float(lo), float(hi))
        flat = flat + idx * stride
        ok &= good
        stride *= nb
    return flat, ok, stride


def calc_hist(channels, bins, ranges, mask=None, density: bool = False) -> torch.Tensor:
    """N-dimensional uniform histogram over the given channels (calcHist
    semantics). channels: list of [H, W] tensors on one device; bins:
    list of ints; ranges: list of (lo, hi). Returns f32 of shape `bins`."""
    flat, ok, n = _flat_bins(channels, bins, ranges)
    if mask is not None:
        ok &= torch.as_tensor(mask, device=flat.device).to(torch.bool)
    hist = torch.bincount(flat[ok], minlength=n).to(torch.float32).reshape(tuple(bins))
    if density:
        hist = hist / hist.sum().clamp(min=1e-12)
    return hist


def calc_back_project(channels, hist: torch.Tensor, ranges, scale: float = 1.0) -> torch.Tensor:
    """Per-pixel histogram lookup (calcBackProject): out[p] =
    hist[bin(p)] * scale, 0 outside the ranges."""
    flat, ok, _ = _flat_bins(channels, hist.shape, ranges)
    vals = hist.reshape(-1)[flat]
    return torch.where(ok, vals * scale, 0.0)


def _moment_integrals(prob: torch.Tensor, order2: bool = False) -> torch.Tensor:
    """Exclusive 2-D prefix sums [M, H+1, W+1] of P, P·x, P·y (+ P·x²,
    P·y², P·xy): down the rows first, then along them, each in XLA's
    order."""
    h, w = prob.shape
    p = prob.to(torch.float32)
    xx = torch.arange(w, dtype=torch.float32, device=p.device)[None, :]
    yy = torch.arange(h, dtype=torch.float32, device=p.device)[:, None]
    planes = [p, p * xx, p * yy]
    if order2:
        planes += [p * xx * xx, p * yy * yy, p * xx * yy]
    rows = imgproc._block_scan(torch.stack(planes).transpose(-1, -2)).transpose(-1, -2)
    return F.pad(imgproc._block_scan(rows.contiguous()), (1, 0, 1, 0))


def _window_sums(ii: torch.Tensor, x: int, y: int, w: int, h: int) -> np.ndarray:
    """Sums over rows [y, y+h) and cols [x, x+w) of every moment plane,
    read back as f32 numpy [M] (one host read)."""
    c = ii[:, [y, y, y + h, y + h], [x, x + w, x, x + w]]  # tl, tr, bl, br
    return (c[:, 3] - c[:, 1] - c[:, 2] + c[:, 0]).cpu().numpy()


def mean_shift(prob: torch.Tensor, window, max_iter: int = 100, eps: float = 1.0):
    """cv::meanShift (camshift.cpp:44): move the window to its centre of
    mass until it moves less than eps. prob [H, W] non-negative; window
    (x, y, w, h). Returns (n_iters, (x, y, w, h)) as Python ints."""
    h_img, w_img = prob.shape
    x0, y0, w0, h0 = [int(v) for v in window]
    # entry clip (reference: window &= Rect(0, 0, W, H))
    x0 = max(x0, 0)
    y0 = max(y0, 0)
    w0 = max(min(w0, w_img - x0), 1)
    h0 = max(min(h0, h_img - y0), 1)

    ii = _moment_integrals(prob)
    eps2 = _f32(round(max(eps, 0.0) ** 2))
    i, x, y = 0, x0, y0
    while i < max_iter:
        s, sx, sy = _window_sums(ii, x, y, w0, h0)
        empty = abs(s) < _f32(1e-12)
        d = _f32(1.0) if empty else s
        # ROI-local centroid = global centroid - x
        dx = int(np.round(sx / d - _f32(x) - _f32(w0 * 0.5)))
        dy = int(np.round(sy / d - _f32(y) - _f32(h0 * 0.5)))
        nx = min(max(x + dx, 0), w_img - w0)
        ny = min(max(y + dy, 0), h_img - h0)
        stop = empty or _f32((nx - x) ** 2 + (ny - y) ** 2) < eps2
        if not empty:
            x, y = nx, ny
        if stop:
            # the reference breaks before ++i: a stopping step does not count
            break
        i += 1
    return i, (x, y, w0, h0)


def cam_shift(prob: torch.Tensor, window, max_iter: int = 100, eps: float = 1.0):
    """cv::CamShift (camshift.cpp:110): meanShift, then orientation and size
    from the second-order central moments of the converged window widened
    by TOLERANCE. Returns ((cx, cy), (width, length), angle_deg) as f32
    numpy scalars, and the next search window (x, y, w, h) as ints."""
    tolerance = 10
    h_img, w_img = prob.shape
    _, (x, y, w, h) = mean_shift(prob, window, max_iter, eps)
    # widen with the reference's clamp order
    x = max(x - tolerance, 0)
    y = max(y - tolerance, 0)
    w = min(w + 2 * tolerance, w_img - x)
    h = min(h + 2 * tolerance, h_img - y)

    s, sx, sy, sxx, syy, sxy = _window_sums(_moment_integrals(prob, order2=True), x, y, w, h)
    inv = _f32(1.0) / max(s, _f32(1e-12))
    xc = sx * inv  # global coordinates (central moments are translation-invariant)
    yc = sy * inv
    mu20 = (sxx - sx * sx * inv) * inv
    mu02 = (syy - sy * sy * inv) * inv
    mu11 = (sxy - sx * sy * inv) * inv

    four, two = _f32(4), _f32(2)
    square = np.sqrt(four * mu11 ** 2 + (mu20 - mu02) ** 2)
    theta = np.arctan2(two * mu11, mu20 - mu02 + square)
    cs, sn = np.cos(theta), np.sin(theta)
    rot_a = max(cs * cs * mu20 + two * cs * sn * mu11 + sn * sn * mu02, _f32(0))
    rot_c = max(sn * sn * mu20 - two * cs * sn * mu11 + cs * cs * mu02, _f32(0))
    length = np.sqrt(rot_a) * four
    width = np.sqrt(rot_c) * four
    if length < width:
        length, width = width, length
        cs, sn = sn, cs
        theta = _f32(np.pi * 0.5) - theta

    xci = int(np.round(xc))
    yci = int(np.round(yc))
    t0 = int(max(np.round(abs(length * cs)), np.round(abs(width * sn)))) + 2
    nw = min(t0, (w_img - xci) * 2)
    t0 = int(max(np.round(abs(length * sn)), np.round(abs(width * cs)))) + 2
    nh = min(t0, (h_img - yci) * 2)
    nx = max(0, xci - nw // 2)
    ny = max(0, yci - nh // 2)
    nw = min(w_img - nx, nw)
    nh = min(h_img - ny, nh)

    angle = np.rad2deg(_f32(np.pi * 0.5) + theta)
    angle = np.mod(np.mod(angle, _f32(360)) + _f32(360), _f32(360))
    if angle >= 180:
        angle = angle - _f32(180)
    center = (_f32(nx) + _f32(nw * 0.5), _f32(ny) + _f32(nh * 0.5))
    return (center, (width, length), angle), (nx, ny, nw, nh)


def track_window_sequence(frames_channels, hist, ranges, window, max_iter: int = 100,
                          eps: float = 1.0, device=None):
    """Back-project and CamShift over a frame sequence (the camshiftdemo
    loop). frames_channels: per frame, a list of channel arrays. Returns a
    list of (box, window) per frame. Runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    hist = torch.as_tensor(hist, device=dev).to(torch.float32)
    out = []
    for chs in frames_channels:
        prob = calc_back_project([torch.as_tensor(c, device=dev) for c in chs], hist, ranges)
        box, window = cam_shift(prob, window, max_iter, eps)
        out.append((box, window))
    return out
