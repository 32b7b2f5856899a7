"""AKAZE: nonlinear-diffusion features (port of opencv_tpu/ops/akaze.py;
reference features2d/src/akaze.cpp and kaze/).

The JAX package's formulation, kept as it is:
- a full-resolution nonlinear scale space [L, H, W] by Fast Explicit
  Diffusion (FED step sizes, akaze.py:42-50, rebuilt here by the same
  numpy code) over a Perona-Malik g2 conductivity whose contrast factor k
  is the 70th percentile of the smoothed gradient magnitude
  (akaze.py:73-79: `jnp.percentile`, linear interpolation, here in
  JAX's own arithmetic, `_quantile_linear`; k scales every diffusion step);
- detection: the scale-normalised Hessian determinant per level, 3x3 NMS,
  better than the same pixel on both neighbouring levels, an 8-pixel
  margin, a masked top-k over the whole stack (akaze.py:157-200);
- description: the rotated M-LDB cells of the 2x2, 3x3 and 4x4 grids
  (akaze.py:202-233), each cell the mean of a 3x3 subsample, 486 bits
  packed into int32 [K, 16] with zero padding (akaze.py:236-288). Samples
  come from one flat bilinear gather over the stack (`_flat_bilinear`,
  akaze.py:128-154: positions clamped to w - 1.001, int64 indices here).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import KeyPoints, masked_top_k
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.matching import pack_bits


def fed_taus(total_time: float, tau_max: float = 0.25) -> np.ndarray:
    """FED step sizes whose sum is `total_time` (kaze/fed.cpp
    `fed_tau_by_process_time`, one cycle)."""
    n = int(math.ceil(math.sqrt(3.0 * total_time / tau_max + 0.25) - 0.5 - 1e-8))
    n = max(n, 1)
    scale = 3.0 * total_time / (tau_max * n * (n + 1))
    j = np.arange(n)
    taus = scale * tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    return taus.astype(np.float32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt on either device (XLA's is; torch's
    vectorised f32 sqrt on the CPU is not)."""
    return torch.sqrt(x.double()).to(torch.float32)


def _diffusion_step(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """L += tau * div(g grad L), the JAX step's arithmetic; a neighbour
    outside the image contributes no flux."""
    h, w = L.shape[-2:]
    yy = torch.arange(h, device=L.device)[:, None]
    xx = torch.arange(w, device=L.device)[None, :]

    def flux(dy, dx):
        Ln = imgproc.shift2d(L, dy, dx, fill=0.0)
        gn = imgproc.shift2d(g, dy, dx, fill=0.0)
        inside = (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)
        return torch.where(inside, (g + gn) * (Ln - L), 0.0)

    div = 0.5 * (flux(0, 1) + flux(0, -1) + flux(1, 0) + flux(-1, 0))
    return L + tau * div


def contrast_k(img: torch.Tensor, percentile: float = 70.0) -> torch.Tensor:
    """The percentile of the gradient magnitude of the 7x7, sigma 1
    smoothed image (kaze `compute_k_percentile`), at least 1e-6; 0-d."""
    s = imgproc.gaussian_blur(img, ksize=7, sigma=1.0)
    gx, gy = imgproc.scharr_derivatives(s)
    mag = _sqrt(gx * gx + gy * gy)
    return torch.clamp(_quantile_linear(mag.reshape(-1), percentile / 100.0), min=1e-6)


def _quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(x, q)`, linear: the sorted values at floor and ceil of
    q (n - 1), f32 as JAX takes it, weighted low (1 - w) + high w: two
    products and a sum, each its own kernel. (`torch.quantile` takes a
    lerp, low + w (high - low), which the card may contract into an FMA.)"""
    pos = np.float32(q) * np.float32(x.numel() - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    s = torch.sort(x).values
    return s[lo] * float(np.float32(1.0) - hw) + s[hi] * float(hw)


def nonlinear_scale_space(img: torch.Tensor, n_levels: int = 8, sigma0: float = 1.6,
                          sublevels: int = 4) -> tuple[torch.Tensor, np.ndarray]:
    """(stack f32 [L, H, W], sigmas f32 [L]): sigma_i = sigma0 *
    2^(i / sublevels); the conductivity is recomputed at the start of
    every evolution level."""
    # a device-tensor divisor: CUDA divides by a Python float as a multiply by
    # its reciprocal, which rounds otherwise than the CPU's and XLA's division
    img = img.to(torch.float32) / torch.tensor(255.0, device=img.device)
    sigmas = sigma0 * 2.0 ** (np.arange(n_levels) / sublevels)
    L = imgproc.gaussian_blur(img, ksize=int(2 * math.ceil(2 * sigma0) + 1), sigma=sigma0)
    k = contrast_k(img)
    k2 = k * k
    levels = [L]
    for i in range(1, n_levels):
        t_prev = 0.5 * sigmas[i - 1] ** 2
        t_next = 0.5 * sigmas[i] ** 2
        gx, gy = imgproc.scharr_derivatives(imgproc.gaussian_blur(L, ksize=5, sigma=1.0))
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
        for tau in fed_taus(float(t_next - t_prev)):
            L = _diffusion_step(L, g, float(tau))
        levels.append(L)
    return torch.stack(levels), sigmas.astype(np.float32)


def hessian_response(stack: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """Scale-normalised det(Hessian) per level: sigma^4 (Lxx Lyy - Lxy^2)."""
    gx, gy = imgproc.scharr_derivatives(stack)
    gxx, gxy = imgproc.scharr_derivatives(gx)
    _, gyy = imgproc.scharr_derivatives(gy)
    s2 = torch.from_numpy(sigmas * sigmas).to(stack.device)[:, None, None]
    return s2 * s2 * (gxx * gyy - gxy * gxy)


def _flat_bilinear(stack: torch.Tensor, lvl: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of stack[lvl] at xy (lvl [...], xy [..., 2]) by one
    gather on the flat [L*H*W] buffer; x clamped to [0, w - 1.001], y to
    [0, h - 1.001]."""
    _, h, w = stack.shape
    flat = stack.reshape(-1)
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    base = lvl.to(torch.int64) * (h * w)

    def at(yi, xi):
        return flat[base + yi * w + xi]

    return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
            + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)


def akaze_detect(stack: torch.Tensor, sigmas: np.ndarray, max_keypoints: int = 512,
                 threshold: float = 0.001) -> KeyPoints:
    """Hessian extrema over the evolution stack (AKAZEFeatures
    `Find_Scale_Space_Extremas`)."""
    _, h, w = stack.shape
    dev = stack.device
    resp = hessian_response(stack, sigmas)
    neg = torch.full_like(resp[:1], -1e9)
    spatial = imgproc.nms_2d(resp)
    up = torch.cat([resp[1:], neg], 0)
    dn = torch.cat([neg, resp[:-1]], 0)
    is_max = spatial & (resp >= up) & (resp >= dn) & (resp > threshold)
    margin = 8
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    is_max &= ((yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin))[None]
    flat = resp.reshape(-1)
    idx, keep = masked_top_k(flat, is_max.reshape(-1), max_keypoints)
    lvl = (idx // (h * w)).to(torch.int32)
    rem = idx % (h * w)
    sig = torch.from_numpy(sigmas).to(dev)[lvl.long()]
    return KeyPoints(
        xy=torch.stack([(rem % w).float(), (rem // w).float()], -1),
        response=torch.where(keep, flat[idx], -float("inf")),
        angle=torch.zeros((idx.shape[0],), dtype=torch.float32, device=dev),
        level=lvl,
        size=2.0 * sig,
        valid=keep,
    )


def _mldb_cells():
    """Cell centres and sizes in the unit patch [-1, 1]^2 and the pairs
    within each of the 2x2, 3x3 and 4x4 grids: 29 cells, 162 pairs, three
    channels = 486 bits (the JAX package's numpy construction)."""
    centers = []
    for d in (2, 3, 4):
        step = 2.0 / d
        for i in range(d):
            for j in range(d):
                centers.append((-1 + step * (j + 0.5), -1 + step * (i + 0.5)))
    sizes = [2.0 / d for d in (2, 3, 4) for _ in range(d * d)]
    pairs = []
    off = 0
    for d in (2, 3, 4):
        n = d * d
        for a in range(n):
            for b in range(a + 1, n):
                pairs.append((off + a, off + b))
        off += n
    return (np.asarray(centers, np.float32), np.asarray(sizes, np.float32),
            np.asarray(pairs, np.int32))


CELLS, CELL_SIZE, PAIRS = _mldb_cells()
SUB = np.stack(
    np.meshgrid(np.linspace(-1 / 3, 1 / 3, 3), np.linspace(-1 / 3, 1 / 3, 3)), -1,
).reshape(-1, 2).astype(np.float32)  # 3x3 subsample per cell
MLDB_BITS = 3 * PAIRS.shape[0]  # 486
# cell subsample positions [29 * 9, 2] in unit-patch coordinates, in f32
# as the JAX function computes them
SAMPLE_POINTS = (CELLS[:, None, :] + np.float32(0.5) * CELL_SIZE[:, None, None] * SUB[None]
                 ).reshape(-1, 2)
# orientation votes: two rings of 8 unit offsets
_CIRCLE = np.asarray([(r * math.cos(2 * math.pi * a / 8), r * math.sin(2 * math.pi * a / 8))
                      for r in (0.4, 0.8) for a in range(8)], np.float32)


def _rotate(ca, sa, pts: torch.Tensor) -> torch.Tensor:
    """rot(angle) @ pts per keypoint: [K, P, 2] (the einsum of akaze.py:266)."""
    px, py = pts[:, 0][None], pts[:, 1][None]
    return torch.stack([ca[:, None] * px + (-sa)[:, None] * py,
                        sa[:, None] * px + ca[:, None] * py], -1)


def mldb_channels(stack: torch.Tensor, sigmas: np.ndarray, kp: KeyPoints
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per keypoint and cell [K, 29]: the mean intensity and the mean x and
    y derivatives rotated into the keypoint's frame, on its own evolution
    level (the values the M-LDB bits compare)."""
    dev = stack.device
    gx, gy = imgproc.scharr_derivatives(stack)
    sig = torch.from_numpy(sigmas).to(dev)[kp.level.long()]
    radius = 5.0 * sig
    circle = torch.from_numpy(_CIRCLE).to(dev)
    opos = kp.xy[:, None, :] + 6.0 * sig[:, None, None] * circle[None]
    lvlb = kp.level[:, None].expand(opos.shape[:2])
    ogx = _flat_bilinear(gx, lvlb, opos)
    ogy = _flat_bilinear(gy, lvlb, opos)
    angle = torch.atan2(ogy.sum(1), ogx.sum(1))
    ca, sa = torch.cos(angle), torch.sin(angle)
    pos = kp.xy[:, None, :] + radius[:, None, None] * _rotate(
        ca, sa, torch.from_numpy(SAMPLE_POINTS).to(dev))
    lvlp = kp.level[:, None].expand(pos.shape[:2])
    n_cells = CELLS.shape[0]
    mi = _flat_bilinear(stack, lvlp, pos).reshape(-1, n_cells, 9).mean(-1)
    mx0 = _flat_bilinear(gx, lvlp, pos).reshape(-1, n_cells, 9).mean(-1)
    my0 = _flat_bilinear(gy, lvlp, pos).reshape(-1, n_cells, 9).mean(-1)
    mx = ca[:, None] * mx0 + sa[:, None] * my0
    my = -sa[:, None] * mx0 + ca[:, None] * my0
    return mi, mx, my


def akaze_compute(stack: torch.Tensor, sigmas: np.ndarray, kp: KeyPoints) -> torch.Tensor:
    """M-LDB descriptors, int32 [K, 16] (486 bits + zero padding): the
    pairwise comparisons of each channel of `mldb_channels`."""
    dev = stack.device
    mi, mx, my = mldb_channels(stack, sigmas, kp)
    pa = torch.from_numpy(PAIRS[:, 0]).long().to(dev)
    pb = torch.from_numpy(PAIRS[:, 1]).long().to(dev)
    bits = torch.cat([mi[:, pa] > mi[:, pb], mx[:, pa] > mx[:, pb], my[:, pa] > my[:, pb]], 1)
    pad = torch.zeros((bits.shape[0], 512 - MLDB_BITS), dtype=torch.bool, device=dev)
    return pack_bits(torch.cat([bits, pad], 1))


def akaze_detect_and_compute(img, max_keypoints: int = 512, threshold: float = 0.001,
                             n_levels: int = 8, device=None) -> tuple[KeyPoints, torch.Tensor]:
    """AKAZE detect + describe (AKAZE::create with DESCRIPTOR_MLDB analog):
    (KeyPoints [K], int32 [K, 16]). Runs on the card unless
    `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    stack, sigmas = nonlinear_scale_space(img, n_levels=n_levels)
    kp = akaze_detect(stack, sigmas, max_keypoints, threshold)
    return kp, akaze_compute(stack, sigmas, kp)
