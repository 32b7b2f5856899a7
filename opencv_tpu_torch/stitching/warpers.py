"""Projection warpers (port of opencv_tpu/stitching/warpers.py; reference
stitching/src/warpers.cpp): cylindrical and spherical backward warps, each
one output->input map and one bilinear sample.

The maps use f32 sin, cos and tan, which can differ from XLA's by an ulp:
the warps agree with the JAX functions to a tolerance, not bit for bit.
The divisions by the focal length divide by a device tensor, so the card
and the CPU divide alike.
"""

from __future__ import annotations

import math

import torch

from opencv_tpu_torch.core import imgproc


def _axis(n: int, centre: float, f: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=f.device) - centre) / f


def _sample_valid(img, x, y, valid) -> torch.Tensor:
    h, w = img.shape
    xy = torch.stack([x, y], -1)
    valid = valid & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return torch.where(valid, imgproc.bilinear_sample(img, xy), 0.0)


def warp_cylindrical(img: torch.Tensor, f: float, out_w: int | None = None,
                     out_h: int | None = None) -> torch.Tensor:
    """Project onto a cylinder of radius f (CylindricalWarper analog)."""
    img = img.to(torch.float32)
    h, w = img.shape
    out_w = out_w or w
    out_h = out_h or h
    ft = torch.tensor(f, dtype=torch.float32, device=img.device)
    theta = _axis(out_w, out_w / 2.0, ft)[None, :]
    hh = _axis(out_h, out_h / 2.0, ft)[:, None]
    x = (f * torch.tan(theta) + w / 2.0).expand(out_h, out_w)
    y = f * hh / torch.cos(theta) + h / 2.0
    return _sample_valid(img, x, y, (theta.abs() < math.pi / 2).expand(out_h, out_w))


def warp_spherical(img: torch.Tensor, f: float, out_w: int | None = None,
                   out_h: int | None = None) -> torch.Tensor:
    """SphericalWarper analog: (u, v) = (theta, phi) equirectangular."""
    img = img.to(torch.float32)
    h, w = img.shape
    out_w = out_w or w
    out_h = out_h or h
    ft = torch.tensor(f, dtype=torch.float32, device=img.device)
    theta = _axis(out_w, out_w / 2.0, ft)[None, :]
    phi = _axis(out_h, out_h / 2.0, ft)[:, None]
    sx = torch.sin(theta) * torch.cos(phi)
    sy = torch.sin(phi)
    sz = torch.cos(theta) * torch.cos(phi)
    z = sz.clamp(min=1e-6)
    x = f * sx / z + w / 2.0
    y = (f * sy / z + h / 2.0).expand(out_h, out_w)
    return _sample_valid(img, x, y, sz > 0)
