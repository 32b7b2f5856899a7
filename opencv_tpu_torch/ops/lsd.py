"""LSD line-segment detector (port of opencv_tpu/ops/lsd.py; von Gioi et
al., modules/imgproc/src/lsd.cpp:1).

The dense stages (Gaussian downscale, 2x2-block gradients, level-line
angles, magnitudes) are tensor ops on the device, in the JAX functions'
order: the blur and resize are the port's bit-equal `imgproc` ones, and
`atan2` may differ from XLA's by an ulp. The sequential region growing,
rectangle fit and density validation are the JAX module's host numpy,
copied (seeds in a stable `argsort`): given the same gradient maps they
give the same segments.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import on_device


def _gradients(img: torch.Tensor):
    """lsd.cpp computes gradients on 2x2 blocks: gx = mean of the two
    x-differences, gy of the two y-differences (at pixel corners)."""
    a = img[:-1, :-1]
    b = img[:-1, 1:]
    c = img[1:, :-1]
    d = img[1:, 1:]
    gx = 0.5 * ((b - a) + (d - c))
    gy = 0.5 * ((c - a) + (d - b))
    mag = torch.sqrt(gx * gx + gy * gy)
    # level-line angle (perpendicular to the gradient)
    angle = torch.atan2(gx, -gy)
    return gx, gy, mag, angle


def _angle_diff(a, b):
    """DIRECTIONAL (2-pi) angle distance: LSD's isAligned treats
    opposite level-line directions as NOT aligned — the two edges of a
    bright ribbon form two separate regions (lsd.cpp isAligned)."""
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def gradient_maps(img, scale: float = 0.8, sigma_scale: float = 0.6, device=None):
    """(magnitude, level-line angle) f32 [h-1, w-1] of the image after the
    Gaussian downscale by `scale`, on the device."""
    img = on_device(img, device).to(torch.float32)
    h0, w0 = img.shape
    if scale != 1.0:
        sigma = sigma_scale / scale
        ksize = int(2 * np.ceil(3.0 * sigma) + 1)
        sm = imgproc.gaussian_blur(img, ksize, sigma)
        work = imgproc.resize_bilinear(sm, int(round(h0 * scale)), int(round(w0 * scale)))
    else:
        work = img
    _, _, mag, angle = _gradients(work)
    return mag, angle


def detect_lines(
    img,
    scale: float = 0.8,
    sigma_scale: float = 0.6,
    quant: float = 2.0,
    ang_th_deg: float = 22.5,
    density_th: float = 0.7,
    min_length: float = 0.0,
    device=None,
) -> np.ndarray:
    """Detect line segments. Returns [N, 4] f32 numpy (x1, y1, x2, y2) in
    input-image coordinates (like cv2.createLineSegmentDetector.detect,
    which returns [N, 1, 4])."""
    mag, angle = gradient_maps(img, scale, sigma_scale, device)
    return segments_from_maps(mag, angle, scale, quant, ang_th_deg, density_th, min_length)


def segments_from_maps(mag, angle, scale: float = 0.8, quant: float = 2.0,
                       ang_th_deg: float = 22.5, density_th: float = 0.7,
                       min_length: float = 0.0) -> np.ndarray:
    """The host stage of `detect_lines` on (magnitude, angle) maps of
    `gradient_maps` (tensors or numpy): region growing from seeds in
    decreasing magnitude, rectangle fit, density gate."""
    mag_np = mag.cpu().numpy() if isinstance(mag, torch.Tensor) else np.asarray(mag)
    ang_np = angle.cpu().numpy() if isinstance(angle, torch.Tensor) else np.asarray(angle)
    gh, gw = mag_np.shape

    # gradient-magnitude threshold (lsd.cpp: rho = quant / sin(ang_th))
    ang_th = np.deg2rad(ang_th_deg)
    rho = quant / np.sin(ang_th)

    usable = mag_np > rho
    # seeds in decreasing magnitude via 1024-bin pseudo-ordering
    # (the reference's pseudo-sort, lsd.cpp ll_angle bins)
    order = np.argsort(-mag_np, axis=None, kind="stable")
    used = np.zeros((gh, gw), bool)
    segments = []

    prec = ang_th
    min_reg_size = int(
        -2.5 * (np.log10(gh) + np.log10(gw)) / np.log10(ang_th / np.pi)
    )
    min_reg_size = max(min_reg_size, 5)

    for flat in order:
        sy, sx = divmod(int(flat), gw)
        if used[sy, sx] or not usable[sy, sx]:
            continue
        # ---- region grow (vectorized frontier flood) ----
        region = np.zeros((gh, gw), bool)
        region[sy, sx] = True
        reg_angle = ang_np[sy, sx]
        sx_sum = np.sin(reg_angle)
        cx_sum = np.cos(reg_angle)
        frontier = region.copy()
        while frontier.any():
            # 8-dilate the frontier
            f = frontier
            grown = np.zeros_like(f)
            grown[:-1, :] |= f[1:, :]
            grown[1:, :] |= f[:-1, :]
            grown[:, :-1] |= f[:, 1:]
            grown[:, 1:] |= f[:, :-1]
            grown[:-1, :-1] |= f[1:, 1:]
            grown[:-1, 1:] |= f[1:, :-1]
            grown[1:, :-1] |= f[:-1, 1:]
            grown[1:, 1:] |= f[:-1, :-1]
            cand = grown & ~region & ~used & usable
            if not cand.any():
                break
            ok = cand & (_angle_diff(ang_np, reg_angle) < prec)
            if not ok.any():
                break
            region |= ok
            ys, xs = np.nonzero(ok)
            sx_sum += np.sin(ang_np[ys, xs]).sum()
            cx_sum += np.cos(ang_np[ys, xs]).sum()
            reg_angle = np.arctan2(sx_sum, cx_sum)
            frontier = ok
        n_pix = int(region.sum())
        used |= region  # seeds of failed regions stay consumed
        if n_pix < min_reg_size:
            continue

        # ---- rectangle fit from magnitude-weighted moments ----
        ys, xs = np.nonzero(region)
        wgt = mag_np[ys, xs]
        wsum = wgt.sum()
        cx = (wgt * xs).sum() / wsum
        cy = (wgt * ys).sum() / wsum
        dxx = (wgt * (xs - cx) ** 2).sum() / wsum
        dyy = (wgt * (ys - cy) ** 2).sum() / wsum
        dxy = (wgt * (xs - cx) * (ys - cy)).sum() / wsum
        # main axis = LARGEST-eigenvalue eigenvector of the scatter
        # matrix (lsd.cpp get_theta works on the inertia matrix, whose
        # smallest eigenvalue marks the same axis)
        lam = 0.5 * (dxx + dyy + np.sqrt((dxx - dyy) ** 2 + 4 * dxy**2))
        theta = (
            np.arctan2(dxy, lam - dyy)
            if abs(dxx) > abs(dyy)
            else np.arctan2(lam - dxx, dxy)
        )
        ux, uy = np.cos(theta), np.sin(theta)
        proj = (xs - cx) * ux + (ys - cy) * uy
        perp = -(xs - cx) * uy + (ys - cy) * ux
        l0, l1 = proj.min(), proj.max()
        width = max(2.0 * np.abs(perp).max(), 1.0)
        length = l1 - l0
        if length < 1.0:
            continue
        density = n_pix / (length * width)
        if density < density_th:
            continue
        x1, y1 = cx + l0 * ux, cy + l0 * uy
        x2, y2 = cx + l1 * ux, cy + l1 * uy
        # +0.5: gradient grid sits at pixel corners; /scale back to input
        seg = (np.array([x1, y1, x2, y2]) + np.array([0.5, 0.5, 0.5, 0.5]))
        seg /= scale
        if np.hypot(seg[2] - seg[0], seg[3] - seg[1]) >= min_length:
            segments.append(seg.astype(np.float32))

    return (
        np.stack(segments) if segments else np.zeros((0, 4), np.float32)
    )
