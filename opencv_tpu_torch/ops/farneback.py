"""Farneback dense optical flow (port of opencv_tpu/ops/farneback.py;
reference video/src/optflowgf.cpp, cudaoptflow farneback.cu).

Per-pixel quadratic polynomial expansion by Gaussian-weighted least
squares: six separable correlations and one constant 6x6 inverse Gram
matrix (farneback.py:26-48, rebuilt here by the same numpy code), then
displacement updates from window-averaged 2x2 normal equations,
coarse-to-fine on the octave pyramid (`core/pyramid.build_lk_pyramid`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.pyramid import build_lk_pyramid
from opencv_tpu_torch.device import no_tf32, resolve_device


@functools.cache
def poly_exp_setup(n: int, sigma: float):
    """1-D kernels (g, x g, x^2 g) and the inverse Gram matrix over the
    basis {1, x, y, x^2, y^2, xy} with weights g(x) g(y), all f32."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    k0, k1, k2 = g, x * g, x * x * g
    xx, yy = np.meshgrid(x, x)
    wgt = np.outer(g, g)
    basis = [np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy]
    G = np.zeros((6, 6))
    for i in range(6):
        for j in range(6):
            G[i, j] = np.sum(wgt * basis[i] * basis[j])
    return (k0.astype(np.float32), k1.astype(np.float32), k2.astype(np.float32),
            np.linalg.inv(G).astype(np.float32))


def poly_expansion(img: torch.Tensor, n: int = 5, sigma: float = 1.1) -> torch.Tensor:
    """[H, W, 6] polynomial coefficients (r1..r6) per pixel."""
    k0, k1, k2, ginv = poly_exp_setup(n, sigma)
    m = torch.stack([
        imgproc.sep_filter2d(img, k0, k0),  # <f, 1>
        imgproc.sep_filter2d(img, k0, k1),  # <f, x>
        imgproc.sep_filter2d(img, k1, k0),  # <f, y>
        imgproc.sep_filter2d(img, k0, k2),
        imgproc.sep_filter2d(img, k2, k0),
        imgproc.sep_filter2d(img, k1, k1),
    ], dim=-1)
    with no_tf32():
        return m @ torch.from_numpy(ginv).to(img.device).T


def _flow_from_polys(r1: torch.Tensor, r2: torch.Tensor, flow: torch.Tensor, avg_win: int
                     ) -> torch.Tensor:
    """One displacement update (optflowgf.cpp UpdateFlow*): warp frame 2's
    polynomials by the flow, average the normal equations over the
    window, solve."""
    h, w = r1.shape[:2]
    ys, xs = imgproc._pixel_grid(h, w, r1.device)
    sample_xy = torch.stack([xs + flow[..., 0], ys + flow[..., 1]], dim=-1)
    r2w = imgproc.bilinear_sample(r2.permute(2, 0, 1), sample_xy).permute(1, 2, 0)
    a11 = 0.5 * (r1[..., 3] + r2w[..., 3])
    a22 = 0.5 * (r1[..., 4] + r2w[..., 4])
    a12 = 0.25 * (r1[..., 5] + r2w[..., 5])
    db1 = -0.5 * (r2w[..., 1] - r1[..., 1]) + a11 * flow[..., 0] + a12 * flow[..., 1]
    db2 = -0.5 * (r2w[..., 2] - r1[..., 2]) + a12 * flow[..., 0] + a22 * flow[..., 1]
    g11, g12, g22, h1, h2 = imgproc.box_filter(torch.stack([
        a11 * a11 + a12 * a12, a12 * (a11 + a22), a22 * a22 + a12 * a12,
        a11 * db1 + a12 * db2, a12 * db1 + a22 * db2]), avg_win)
    det = g11 * g22 - g12 * g12
    det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
    return torch.stack([(g22 * h1 - g12 * h2) / det, (g11 * h2 - g12 * h1) / det], dim=-1)


def upscale_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Flow [h', w', 2] of the coarser octave -> [h, w, 2], doubled."""
    return imgproc.resize_bilinear(flow.permute(2, 0, 1), h, w).permute(1, 2, 0) * 2.0


def calc_optical_flow_farneback(
    prev_img,
    next_img,
    n_levels: int = 3,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
    win_size: int = 15,
    device=None,
) -> torch.Tensor:
    """Dense flow f32 [H, W, 2] (x, y) from prev to next. Runs on the card
    unless `device="cpu"`."""
    dev = resolve_device(device)
    p1 = build_lk_pyramid(torch.as_tensor(prev_img, device=dev).to(torch.float32), n_levels)
    p2 = build_lk_pyramid(torch.as_tensor(next_img, device=dev).to(torch.float32), n_levels)
    flow = None
    for lvl in range(n_levels - 1, -1, -1):
        i1, i2 = p1.levels[lvl], p2.levels[lvl]
        h, w = i1.shape
        if flow is None:
            flow = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
        else:
            flow = upscale_flow(flow, h, w)
        r1 = poly_expansion(i1, poly_n, poly_sigma)
        r2 = poly_expansion(i2, poly_n, poly_sigma)
        for _ in range(iterations):
            flow = _flow_from_polys(r1, r2, flow, win_size)
    return flow
