"""Multi-frame super-resolution, BTV-L1 (port of opencv_tpu/ops/superres.py;
reference superres/src/btv_l1.cpp).

Subgradient descent on || D H W_k x - y_k ||_1 + lambda BTV(x) over the
high-resolution image x: per-frame translations (`btv_l1_superres`) or
dense flows (`btv_l1_superres_flow`, the reference's full mode, the
adjoint warp by the backward flows). The JAX function maps the frames'
data terms with `vmap` and iterates with `lax.fori_loop`; here the frames
are a batch dimension and the iterations a Python loop.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device


def _downsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Blur and decimate (D H of the observation model)."""
    return imgproc.gaussian_blur(x, 2 * scale + 1, scale * 0.5)[..., ::scale, ::scale]


def _upsample_adjoint(r: torch.Tensor, shape, scale: int) -> torch.Tensor:
    """Zero-stuff r [..., h, w] to `shape`, blur, times scale^2 (the
    adjoint of `_downsample`)."""
    up = torch.zeros(shape, dtype=torch.float32, device=r.device)
    up[..., ::scale, ::scale] = r
    return imgproc.gaussian_blur(up, 2 * scale + 1, scale * 0.5) * (scale * scale)


def _warp(x: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Frame k of x [K, H, W] sampled at (x + fx[k], y + fy[k]), bilinear
    with edge clamping: `imgproc.bilinear_sample`'s arithmetic, with each
    frame gathering at its own positions."""
    k, h, w = x.shape
    ys, xs = imgproc._pixel_grid(h, w, x.device)
    px = torch.clamp((xs + fx).expand(k, h, w), 0.0, w - 1.0)
    py = torch.clamp((ys + fy).expand(k, h, w), 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(px).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(py).to(torch.int64), 0, h - 2)
    ax = px - x0.to(torch.float32)
    ay = py - y0.to(torch.float32)
    flat = x.reshape(k, -1)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).reshape(k, -1)).reshape(k, h, w)

    top = at(y0, x0) * (1.0 - ax) + at(y0, x0 + 1) * ax
    bot = at(y0 + 1, x0) * (1.0 - ax) + at(y0 + 1, x0 + 1) * ax
    return top * (1.0 - ay) + bot * ay


def btv_regularizer_grad(x: torch.Tensor, btv_range: int = 2, alpha: float = 0.7) -> torch.Tensor:
    """Subgradient of the bilateral total variation prior."""
    g = torch.zeros_like(x)
    for dy in range(-btv_range, btv_range + 1):
        for dx in range(-btv_range, btv_range + 1):
            if dy == 0 and dx == 0:
                continue
            w = alpha ** (abs(dy) + abs(dx))
            diff = x - imgproc.shift2d(x, dy, dx, 0.0)
            g = g + w * (torch.sign(diff) - torch.sign(imgproc.shift2d(diff, -dy, -dx, 0.0)))
    return g


def _descend(x0: torch.Tensor, data_grad, iters: int, lam: float, step: float) -> torch.Tensor:
    x = x0
    for _ in range(iters):
        g = data_grad(x) + lam * btv_regularizer_grad(x)
        x = torch.clamp(x - step * g, 0.0, 255.0)
    return x


def btv_l1_superres(
    frames,  # [K, h, w] low-res frames
    shifts,  # [K, 2] (dx, dy) of each frame against the reference, low-res px
    scale: int = 2,
    iters: int = 60,
    lam: float = 0.03,
    step: float = 0.5,
    device=None,
) -> torch.Tensor:
    """The [h * scale, w * scale] image from translated low-res frames.
    Runs on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev).to(torch.float32)
    k, h, w = frames.shape
    hs = torch.as_tensor(shifts, device=dev).to(torch.float32) * scale
    fx, fy = hs[:, 0, None, None], hs[:, 1, None, None]  # [K, 1, 1]
    x0 = imgproc.resize_bilinear(frames[0], h * scale, w * scale)

    def data_grad(x):
        r = torch.sign(_downsample(_warp(x.expand(k, -1, -1), fx, fy), scale) - frames)
        g = _warp(_upsample_adjoint(r, (k,) + x.shape, scale), -fx, -fy)
        total = g[0]
        for i in range(1, k):  # frame order, as the JAX loop sums them
            total = total + g[i]
        return total / torch.tensor(float(k), device=total.device)  # a true division on CUDA too

    return _descend(x0, data_grad, iters, lam, step)


def _upscale_flow(flow_lo: torch.Tensor, scale: int) -> torch.Tensor:
    """Low-res flows [..., h, w, 2] -> high-res [..., H, W, 2], values scaled."""
    h, w = flow_lo.shape[-3:-1]
    up = imgproc.resize_bilinear(flow_lo.movedim(-1, -3), h * scale, w * scale)
    return up.movedim(-3, -1) * scale


def btv_l1_superres_flow(
    frames,  # [K, h, w] low-res frames
    flows,  # [K, h, w, 2] dense flow reference -> frame k, low-res px
    back_flows,  # [K, h, w, 2] dense flow frame k -> reference
    scale: int = 2,
    iters: int = 60,
    lam: float = 0.03,
    step: float = 0.5,
    device=None,
) -> torch.Tensor:
    """BTV-L1 super-resolution over dense per-pixel motion (any of the
    port's dense flows supplies `flows`); the adjoint warp uses the
    backward flows. Runs on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev).to(torch.float32)
    k, h, w = frames.shape
    fl = _upscale_flow(torch.as_tensor(flows, device=dev).to(torch.float32), scale)
    bf = _upscale_flow(torch.as_tensor(back_flows, device=dev).to(torch.float32), scale)
    x0 = imgproc.resize_bilinear(frames[0], h * scale, w * scale)

    def data_grad(x):
        r = torch.sign(_downsample(_warp(x.expand(k, -1, -1), fl[..., 0], fl[..., 1]), scale)
                       - frames)
        g = _warp(_upsample_adjoint(r, (k,) + x.shape, scale), bf[..., 0], bf[..., 1])
        return g.mean(dim=0)

    return _descend(x0, data_grad, iters, lam, step)
