"""Dual TV-L1 dense optical flow (port of opencv_tpu/ops/tvl1.py;
reference video/src/tvl1flow.cpp, cudaoptflow tvl1flow.cu).

Zach-Pock-Bischof primal-dual iterations over [H, W] fields: per warp the
second image and its Scharr derivatives are sampled at the current flow,
then `iters` steps of the thresholded data step, the primal update from
the duals' divergence and the dual ascent with tvl1flow.cpp's
normalisation (tvl1.py:43-101); coarse-to-fine on the octave pyramid.
The JAX function runs the steps in `lax.fori_loop`; here they are a
Python loop (4 levels x 5 warps x 50 steps at the defaults).
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.pyramid import build_lk_pyramid
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.farneback import upscale_flow


def _grad(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences, zero on the last column / row (Neumann)."""
    ux = imgproc.shift2d(u, 0, 1, 0.0) - u
    ux[:, -1] = 0.0
    uy = imgproc.shift2d(u, 1, 0, 0.0) - u
    uy[-1, :] = 0.0
    return ux, uy


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence (the adjoint of -_grad)."""
    dx = px - imgproc.shift2d(px, 0, -1, 0.0)
    dx[:, 0] = px[:, 0]
    dy = py - imgproc.shift2d(py, -1, 0, 0.0)
    dy[0, :] = py[0, :]
    return dx + dy


def _data_step(rho, th, lt, ix, grad2):
    """The thresholding step of one flow component."""
    return torch.where(rho < -th, lt * ix,
                       torch.where(rho > th, -lt * ix, -rho * ix / torch.clamp(grad2, min=1e-9)))


def _tvl1_level(i0, i1, u0, lam=0.15, theta=0.3, tau=0.25, warps=5, iters=30):
    h, w = i0.shape
    ys, xs = imgproc._pixel_grid(h, w, i0.device)
    u = u0
    p = torch.zeros((4, h, w), dtype=torch.float32, device=i0.device)  # p11, p12, p21, p22
    i1dx, i1dy = imgproc.scharr_derivatives(i1)
    sigma = tau / theta
    lt = lam * theta
    for _ in range(warps):
        coords = torch.stack([xs + u[..., 0], ys + u[..., 1]], dim=-1)
        i1w, i1x, i1y = imgproc.bilinear_sample(torch.stack([i1, i1dx, i1dy]), coords)
        grad2 = i1x * i1x + i1y * i1y
        rho_c = i1w - i1x * u[..., 0] - i1y * u[..., 1] - i0
        th = lt * grad2
        for _ in range(iters):
            rho = rho_c + i1x * u[..., 0] + i1y * u[..., 1]
            v1 = u[..., 0] + _data_step(rho, th, lt, i1x, grad2)
            v2 = u[..., 1] + _data_step(rho, th, lt, i1y, grad2)
            u1 = v1 + theta * _div(p[0], p[1])
            u2 = v2 + theta * _div(p[2], p[3])
            u = torch.stack([u1, u2], dim=-1)
            u1x, u1y = _grad(u1)
            u2x, u2y = _grad(u2)
            n1 = 1.0 + sigma * torch.sqrt(u1x ** 2 + u1y ** 2)
            n2 = 1.0 + sigma * torch.sqrt(u2x ** 2 + u2y ** 2)
            p = torch.stack([(p[0] + sigma * u1x) / n1, (p[1] + sigma * u1y) / n1,
                             (p[2] + sigma * u2x) / n2, (p[3] + sigma * u2y) / n2])
        u = torch.clamp(u, -float(max(h, w)), float(max(h, w)))  # runaway flow
    return u


def calc_optical_flow_tvl1(
    prev_img,
    next_img,
    n_levels: int = 4,
    lam: float = 0.05,
    theta: float = 0.3,
    warps: int = 5,
    iters: int = 50,
    device=None,
) -> torch.Tensor:
    """Dense flow f32 [H, W, 2] (cv::DualTVL1OpticalFlow analog; images at
    their 8-bit scale, lambda absorbs it). Runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    p0 = build_lk_pyramid(torch.as_tensor(prev_img, device=dev).to(torch.float32), n_levels)
    p1 = build_lk_pyramid(torch.as_tensor(next_img, device=dev).to(torch.float32), n_levels)
    flow = None
    for lvl in range(n_levels - 1, -1, -1):
        i0, i1 = p0.levels[lvl], p1.levels[lvl]
        h, w = i0.shape
        if flow is None:
            flow = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
        else:
            flow = upscale_flow(flow, h, w)
        flow = _tvl1_level(i0, i1, flow, lam, theta, warps=warps, iters=iters)
    return flow
