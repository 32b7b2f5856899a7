"""Flow-based frame interpolation (port of opencv_tpu/ops/interpolate.py;
reference cudalegacy interpolate_frames.cpp, cuda::interpolateFrames).

The frame at time t from forward and backward dense flow: one backward
bilinear warp from each side, blended by t where forward-backward flow is
consistent, the temporally closer frame alone where it is not.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import farneback


def _backward_warp(img: torch.Tensor, flow: torch.Tensor, scale: float) -> torch.Tensor:
    """img [..., H, W] sampled at x + scale * flow(x)."""
    h, w = img.shape[-2:]
    ys, xs = imgproc._pixel_grid(h, w, img.device)
    return imgproc.bilinear_sample(
        img, torch.stack([xs + scale * flow[..., 0], ys + scale * flow[..., 1]], -1))


def interpolate_frames(f0, f1, t: float = 0.5, flow_fn=None, device=None) -> torch.Tensor:
    """Frame f32 [H, W] at time t between f0 and f1. flow_fn(a, b) ->
    [H, W, 2]; by default the port's Farneback on the same device. Runs on
    the card unless `device="cpu"`."""
    dev = resolve_device(device)
    if flow_fn is None:
        def flow_fn(a, b):
            return farneback.calc_optical_flow_farneback(a, b, device=dev)

    f0 = torch.as_tensor(f0, device=dev).to(torch.float32)
    f1 = torch.as_tensor(f1, device=dev).to(torch.float32)
    fwd = flow_fn(f0, f1)
    bwd = flow_fn(f1, f0)
    from0 = _backward_warp(f0, fwd, -t)
    from1 = _backward_warp(f1, bwd, -(1.0 - t))
    bwd_at_fwd = _backward_warp(bwd.permute(2, 0, 1), fwd, 1.0).permute(1, 2, 0)
    s = fwd + bwd_at_fwd
    consistent = torch.sqrt(s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]) < 1.0
    w0_occ, w1_occ = (1.0, 0.0) if t < 0.5 else (0.0, 1.0)
    w0 = torch.where(consistent, 1.0 - t, w0_occ)
    w1 = torch.where(consistent, t, w1_occ)
    return (w0 * from0 + w1 * from1) / torch.clamp(w0 + w1, min=1e-6)
