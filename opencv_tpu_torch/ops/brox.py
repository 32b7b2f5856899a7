"""Brox variational optical flow (port of opencv_tpu/ops/brox.py;
reference cudalegacy NCVBroxOpticalFlow.cu, cuda::BroxOpticalFlow).

Brightness and gradient constancy with Charbonnier penalties and a
smoothness term, coarse-to-fine over a 0.7-scaled pyramid: per level
`outer_iters` linearisations, each with 3 lagged-diffusivity refreshes of
the robust weights and `solver_iters` Jacobi sweeps of the linear system
(brox.py:59-151). The JAX function nests `lax.fori_loop`s; here they are
Python loops (6 levels x 5 x 3 x 20 at the defaults).
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device

_NEIGHBOURS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _charbonnier_prime(x2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """psi'(s^2) for psi(s^2) = sqrt(s^2 + eps^2)."""
    return 0.5 / torch.sqrt(x2 + eps)


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    ys, xs = imgproc._pixel_grid(h, w, img.device)
    return imgproc.bilinear_sample(img, torch.stack([xs + u, ys + v], -1))


def _level_flow(i1, i2, u, v, alpha, gamma, outer_iters, solver_iters):
    i1x, i1y = imgproc.scharr_derivatives(i1)
    for _ in range(outer_iters):
        u0, v0 = u, v
        i2w = _warp(i2, u0, v0)
        ix, iy = imgproc.scharr_derivatives(i2w)
        it = i2w - i1
        ixx, ixy = imgproc.scharr_derivatives(ix)
        _, iyy = imgproc.scharr_derivatives(iy)
        itx = ix - i1x
        ity = iy - i1y
        # residual constants in terms of the total flow w
        c_b = it - ix * u0 - iy * v0
        c_gx = itx - ixx * u0 - ixy * v0
        c_gy = ity - ixy * u0 - iyy * v0
        wu, wv = u0, v0
        for _ in range(3):  # lagged diffusivity: freeze the weights, solve the linear system
            r_b = c_b + ix * wu + iy * wv
            psi_b = _charbonnier_prime(r_b * r_b)
            r_gx = c_gx + ixx * wu + ixy * wv
            r_gy = c_gy + ixy * wu + iyy * wv
            psi_g = _charbonnier_prime(r_gx * r_gx + r_gy * r_gy)
            ux, uy = imgproc.scharr_derivatives(wu)
            vx, vy = imgproc.scharr_derivatives(wv)
            psi_s = _charbonnier_prime(ux * ux + uy * uy + vx * vx + vy * vy)
            a11 = psi_b * ix * ix + gamma * psi_g * (ixx * ixx + ixy * ixy)
            a12 = psi_b * ix * iy + gamma * psi_g * (ixx * ixy + ixy * iyy)
            a22 = psi_b * iy * iy + gamma * psi_g * (ixy * ixy + iyy * iyy)
            rhs1 = -psi_b * ix * c_b - gamma * psi_g * (ixx * c_gx + ixy * c_gy)
            rhs2 = -psi_b * iy * c_b - gamma * psi_g * (ixy * c_gx + iyy * c_gy)
            wgt_n = [0.5 * (psi_s + imgproc.shift2d(psi_s, dy, dx, fill=0.0))
                     for dy, dx in _NEIGHBOURS]
            wsum = wgt_n[0] + wgt_n[1] + wgt_n[2] + wgt_n[3]
            den_u = torch.clamp(a11 + alpha * wsum, min=1e-9)
            den_v = torch.clamp(a22 + alpha * wsum, min=1e-9)
            for _ in range(solver_iters):
                su = torch.zeros_like(wu)
                sv = torch.zeros_like(wv)
                for wn, (dy, dx) in zip(wgt_n, _NEIGHBOURS):
                    su = su + wn * imgproc.shift2d(wu, dy, dx, fill=0.0)
                    sv = sv + wn * imgproc.shift2d(wv, dy, dx, fill=0.0)
                wu = (rhs1 - a12 * wv + alpha * su) / den_u
                wv = (rhs2 - a12 * wu + alpha * sv) / den_v
        u = u0 + torch.clamp(wu - u0, -3.0, 3.0)
        v = v0 + torch.clamp(wv - v0, -3.0, 3.0)
    return u, v


def brox_flow(
    i1,
    i2,
    alpha: float = 1.0,
    gamma: float = 0.5,
    scale_factor: float = 0.7,
    n_levels: int = 6,
    outer_iters: int = 5,
    solver_iters: int = 20,
    device=None,
) -> torch.Tensor:
    """Dense flow f32 [H, W, 2] from i1 to i2 (cuda::BroxOpticalFlow
    analog; alpha and gamma for 0..255 inputs). Runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    # divide by a device tensor: CUDA divides by a Python float as a multiply
    # by its reciprocal, which rounds otherwise than the CPU's and XLA's division
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    i1 = torch.as_tensor(i1, device=dev).to(torch.float32) / c255
    i2 = torch.as_tensor(i2, device=dev).to(torch.float32) / c255
    h, w = i1.shape
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(h * s)), 8), max(int(round(w * s)), 8)))
    shapes = shapes[::-1]
    u = torch.zeros(shapes[0], dtype=torch.float32, device=dev)
    v = torch.zeros(shapes[0], dtype=torch.float32, device=dev)
    for k, (lh, lw) in enumerate(shapes):
        a = imgproc.resize_bilinear(i1, lh, lw)
        b = imgproc.resize_bilinear(i2, lh, lw)
        if k > 0:
            ph, pw = shapes[k - 1]
            u = imgproc.resize_bilinear(u, lh, lw) * (lw / pw)
            v = imgproc.resize_bilinear(v, lh, lw) * (lh / ph)
        u, v = _level_flow(a, b, u, v, alpha / 255.0, gamma / 255.0, outer_iters, solver_iters)
    return torch.stack([u, v], dim=-1)
