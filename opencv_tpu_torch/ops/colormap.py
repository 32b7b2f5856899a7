"""applyColorMap + Gabor kernels (port of opencv_tpu/ops/colormap.py;
imgproc/src/colormap.cpp, gabor.cpp getGaborKernel).

The LUTs are the JAX module's host numpy, built from the public
closed-form Octave colormap definitions (copied, not imported); a map is
one gather of a [256, 3] LUT, so colormapped images are exact. The Gabor
kernel is the JAX function's f32 arithmetic; `exp` and `cos` may differ
from XLA's by an ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.device import on_device, resolve_device, true_div


def _octave_maps(n=256):
    t = np.linspace(0.0, 1.0, n)
    z = np.zeros(n)
    o = np.ones(n)

    def clip(x):
        return np.clip(x, 0.0, 1.0)

    maps = {}
    maps["autumn"] = np.stack([o, t, z], 1)
    maps["bone"] = np.stack(
        [
            clip(np.where(t < 3 / 4, 7 / 8 * t, 11 / 8 * t - 3 / 8)),
            clip(np.where(t < 3 / 8, 7 / 8 * t,
                          np.where(t < 3 / 4, 29 / 24 * t - 1 / 8,
                                   7 / 8 * t + 1 / 8))),
            clip(np.where(t < 3 / 8, 29 / 24 * t, 7 / 8 * t + 1 / 8)),
        ],
        1,
    )
    maps["cool"] = np.stack([t, 1 - t, o], 1)
    # the reference's HOT anchors ramp r/g over 2/5 each, b over 1/5
    maps["hot"] = np.stack(
        [clip(2.5 * t), clip(2.5 * t - 1), clip(5 * t - 4)], 1
    )
    # Octave hsv: full hue wheel at s=v=1
    h6 = t * 6.0
    maps["hsv"] = np.stack(
        [
            clip(np.abs(h6 - 3) - 1),
            clip(2 - np.abs(h6 - 2)),
            clip(2 - np.abs(h6 - 4)),
        ],
        1,
    )
    maps["jet"] = np.stack(
        [
            clip(1.5 - np.abs(4 * t - 3)),
            clip(1.5 - np.abs(4 * t - 2)),
            clip(1.5 - np.abs(4 * t - 1)),
        ],
        1,
    )
    maps["ocean"] = np.stack(
        [clip(3 * t - 2), clip(1.5 * t - 0.5), t], 1
    )
    # MATLAB pink = sqrt(2/3 gray + 1/3 hot) with the 3/8-ramp hot
    hot83 = np.stack(
        [clip(8 / 3 * t), clip(8 / 3 * t - 1), clip(4 * t - 3)], 1
    )
    maps["pink"] = np.sqrt(clip(2 / 3 * t[:, None] + 1 / 3 * hot83))
    maps["spring"] = np.stack([o, t, 1 - t], 1)
    maps["summer"] = np.stack([t, 0.5 + t / 2, 0.4 * o], 1)
    maps["winter"] = np.stack([z, t, 1 - t / 2], 1)
    # Octave rainbow: piecewise ramps
    r = np.where(t < 2 / 5, 1.0,
                 np.where(t < 3 / 5, -5 * t + 3,
                          np.where(t < 4 / 5, 0.0, 10 / 3 * t - 8 / 3)))
    g = np.where(t < 2 / 5, 5 / 2 * t,
                 np.where(t < 3 / 5, 1.0,
                          np.where(t < 4 / 5, -5 * t + 4, 0.0)))
    b = np.where(t < 3 / 5, 0.0, np.where(t < 4 / 5, 5 * t - 3, 1.0))
    maps["rainbow"] = np.stack([clip(r), clip(g), clip(b)], 1)
    return {k: (v * 255.0).astype(np.float32) for k, v in maps.items()}


_LUTS = _octave_maps()

# cv2 COLORMAP_* ids for the classic family (imgproc.hpp ColormapTypes)
COLORMAP_AUTUMN = "autumn"
COLORMAP_BONE = "bone"
COLORMAP_JET = "jet"
COLORMAP_WINTER = "winter"
COLORMAP_RAINBOW = "rainbow"
COLORMAP_OCEAN = "ocean"
COLORMAP_SUMMER = "summer"
COLORMAP_SPRING = "spring"
COLORMAP_COOL = "cool"
COLORMAP_HSV = "hsv"
COLORMAP_PINK = "pink"
COLORMAP_HOT = "hot"


def apply_color_map(img, colormap: str, device=None) -> torch.Tensor:
    """Map a grayscale image (u8 range) through a colormap LUT.
    Returns [H, W, 3] RGB f32 in [0, 255] (cv2 returns BGR u8)."""
    x = on_device(img, device)
    lut = torch.as_tensor(_LUTS[colormap], device=x.device)
    return lut[x.clamp(0, 255).to(torch.int64)]


def get_gabor_kernel(ksize: tuple[int, int], sigma: float, theta: float, lambd: float,
                     gamma: float, psi: float = np.pi / 2, device=None) -> torch.Tensor:
    """cv::getGaborKernel (imgproc/src/gabor.cpp:1): real Gabor filter
    g(x, y) = exp(-(x'^2 + gamma^2 y'^2) / (2 sigma^2)) *
              cos(2 pi x' / lambda + psi)."""
    kw, kh = ksize
    if kw <= 0:
        kw = int(2 * np.round(
            np.sqrt(-2 * np.log(0.005)) * sigma
            * max(np.abs(np.cos(theta)), np.abs(np.sin(theta)))
        ) + 1) | 1
    if kh <= 0:
        kh = kw
    xmax, ymax = kw // 2, kh // 2
    dev = resolve_device(device)
    yy, xx = torch.meshgrid(torch.arange(-ymax, ymax + 1, dtype=torch.float32, device=dev),
                            torch.arange(-xmax, xmax + 1, dtype=torch.float32, device=dev),
                            indexing="ij")
    xr = xx * np.cos(theta) + yy * np.sin(theta)
    yr = -xx * np.sin(theta) + yy * np.cos(theta)
    ex = torch.exp(true_div(-(xr * xr + (gamma * yr) * (gamma * yr)), 2.0 * sigma ** 2))
    # the reference fills kernel[ymax-y, xmax-x] (gabor.cpp loop), a
    # point reflection — equivalent to negating xr inside the cosine
    return ex * torch.cos(-2.0 * np.pi / lambd * xr + psi)
