"""Stereo block matching (StereoBM) and reprojection to 3D (port of
opencv_tpu/ops/stereo.py; reference calib3d/src/stereobm.cpp).

The disparity axis is a batch dimension: the D SAD cost planes of the
x-Sobel prefiltered pair are box sums (`imgproc.box_sum_integral`, eager
JAX's prefix-sum order, batched over the planes) of one [D, H, W] tensor,
then argmin, the uniqueness and texture gates and the subpixel parabola
(stereo.py:21-82), op for op.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device


def _prefilter(img: torch.Tensor, cap: float) -> torch.Tensor:
    """x-Sobel clamped to +-cap (stereobm.cpp prefilterXSobel)."""
    dx, _ = imgproc.sobel_derivatives(img)
    return torch.clamp(dx, -cap, cap)


def shifted_planes(img: torch.Tensor, disparities) -> torch.Tensor:
    """[D, H, W]: plane i is img moved d_i columns right (img[y, x - d_i]),
    zero where that falls off the left border."""
    return torch.stack([imgproc.shift2d(img, 0, -d, fill=0.0) for d in disparities])


def compute_disparity_bm(
    left,
    right,
    num_disparities: int = 64,
    block_size: int = 15,
    texture_threshold: float = 10.0,
    uniqueness_ratio: float = 0.15,
    prefilter_cap: float = 31.0,
    device=None,
) -> torch.Tensor:
    """Disparity f32 [H, W], -1 where invalid: left[y, x] matches
    right[y, x - d], d in [0, num_disparities). Runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    left = torch.as_tensor(left, device=dev).to(torch.float32)
    right = torch.as_tensor(right, device=dev).to(torch.float32)
    lp = _prefilter(left, prefilter_cap)
    rp = _prefilter(right, prefilter_cap)
    w = left.shape[1]
    ds = torch.arange(num_disparities, device=dev)[:, None, None]
    sad = imgproc.box_sum_integral(torch.abs(lp[None] - shifted_planes(rp, range(num_disparities))),
                                   block_size)
    xs = torch.arange(w, device=dev)[None, None, :]
    cost = torch.where(xs >= ds + block_size // 2, sad, float("inf"))  # [D, H, W]

    cmin, best = torch.min(cost, dim=0)
    far = torch.abs(ds - best[None]) > 1
    second = torch.where(far, cost, float("inf")).amin(dim=0)
    unique = cmin <= second * (1.0 - uniqueness_ratio) + 1e-6
    texture = imgproc.box_sum_integral(torch.abs(lp), block_size)
    textured = texture > texture_threshold * block_size

    bm1 = torch.clamp(best - 1, 0, num_disparities - 1)
    bp1 = torch.clamp(best + 1, 0, num_disparities - 1)
    cm = torch.gather(cost, 0, bm1[None])[0]
    cp = torch.gather(cost, 0, bp1[None])[0]
    denom = cm - 2.0 * cmin + cp
    sub = torch.where(torch.abs(denom) > 1e-9, 0.5 * (cm - cp) / denom, 0.0)
    disp = best.to(torch.float32) + torch.clamp(sub, -0.5, 0.5)
    valid = unique & textured & torch.isfinite(cmin) & (best > 0)
    return torch.where(valid, disp, -1.0)


def reproject_to_3d(disparity: torch.Tensor, fx: float, baseline: float, cx: float,
                    cy: float) -> torch.Tensor:
    """Disparity -> [H, W, 3] points in the left camera frame
    (cv::reprojectImageTo3D analog): Z = f B / d, 0 where d <= 0."""
    h, w = disparity.shape
    dev = disparity.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    fb = torch.full_like(disparity, fx * baseline)  # tensor / tensor: a true division
    z = torch.where(disparity > 0, fb / torch.clamp(disparity, min=1e-6), 0.0)
    fx_t = torch.tensor(fx, dtype=torch.float32, device=dev)  # a true division on CUDA too
    return torch.stack([(xs - cx) * z / fx_t, (ys - cy) * z / fx_t, z.expand(h, w)], dim=-1)
