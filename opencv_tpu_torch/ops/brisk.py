"""BRISK detection and description (port of opencv_tpu/ops/brisk.py;
reference features2d/src/brisk.cpp).

Detection: the AGAST 9_16 score (K2 on the card, see ops/agast.py) on
each level of a sqrt(2) pyramid (`core/pyramid.build_pyramid`, each
level a bilinear resize of level 0), thresholded, `nms_2d`, a masked
top-k per level (brisk.py:160-198): one K2 launch per level.

Description (brisk.py:124-157): the 60-point concentric pattern
(brisk.py:46-76, rebuilt here by the same numpy code), each point read
from the pre-blurred image of a sigma ladder whose level is the argmin of
|log(sigma * scale) - log(ladder)|, the first on ties; orientation from
the long pairs' gradient vote, 512 short-pair comparisons on the rotated
pattern. The JAX function picks the ladder level with a one-hot einsum
(brisk.py:97-121); here a gather takes the same value.

Descriptors are int32 [K, 16] carrying the bit pattern of the JAX
package's uint32 words (bit j of word w is comparison 32 w + j), the
port's convention (ops/orb.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc, pyramid
from opencv_tpu_torch.core.types import KeyPoints, masked_top_k
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import agast
from opencv_tpu_torch.ops.matching import pack_bits

# brisk.cpp generateKernel: radiusList {0, 2.865, 4.9, 7.4, 10.8}, numberList {1, 10, 14, 15, 20}
_RADII = (0.0, 2.865, 4.9, 7.4, 10.8)
_COUNTS = (1, 10, 14, 15, 20)
N_POINTS = sum(_COUNTS)  # 60
N_SHORT = 512  # short pairs -> descriptor bits
_D_MAX = 9.75  # short-pair max distance (pattern units)
_D_MIN = 13.67  # long-pair min distance


def _make_pattern():
    """(points [60, 2] (x, y), sigmas [60], short pairs [512, 2], long
    pairs [L, 2]): the JAX package's numpy construction, step for step."""
    pts, sigmas = [], []
    for r, n in zip(_RADII, _COUNTS):
        sigma = 0.5 if n == 1 else max(0.5, 0.85 * r * math.sin(math.pi / n))
        for i in range(n):
            a = 2.0 * math.pi * i / n
            pts.append((r * math.cos(a), r * math.sin(a)))
            sigmas.append(sigma)
    pts = np.asarray(pts, np.float32)
    sigmas = np.asarray(sigmas, np.float32)
    ii, jj = np.triu_indices(N_POINTS, k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=1)
    long_mask = d > _D_MIN
    short = np.argsort(d)[:N_SHORT]
    if d[short].max() >= _D_MAX + 1.0:
        raise AssertionError("BRISK pattern: a short pair is too long")
    return (pts, sigmas, np.stack([ii[short], jj[short]], 1),
            np.stack([ii[long_mask], jj[long_mask]], 1))


PATTERN_XY, PATTERN_SIGMA, SHORT_PAIRS, LONG_PAIRS = _make_pattern()

# sigma ladder of the smoothed sampling (geometric)
LADDER = np.asarray([0.5, 0.8, 1.3, 2.1, 3.4, 5.4, 8.6, 13.8], np.float32)


def _blur_stack(img: torch.Tensor) -> torch.Tensor:
    """[S, H, W] Gaussian-blurred copies of img at the sigma ladder."""
    outs = []
    for s in LADDER:
        k = int(2 * math.ceil(2.5 * s) + 1)
        outs.append(imgproc.gaussian_blur(img, ksize=min(k, 31), sigma=float(s)))
    return torch.stack(outs)


def _sample_pattern(stack: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Smoothed pattern samples [K, 60] at the rotated and scaled pattern
    positions; each point reads the ladder level nearest (in log) to its
    sigma times the keypoint's scale."""
    dev = stack.device
    pat = torch.from_numpy(PATTERN_XY).to(dev)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px, py = pat[:, 0][None], pat[:, 1][None]
    rx = ca[:, None] * px + (-sa)[:, None] * py  # rot @ pattern, as the einsum
    ry = sa[:, None] * px + ca[:, None] * py
    pos = xy[:, None, :] + scale[:, None, None] * torch.stack([rx, ry], -1)  # [K, 60, 2]
    vals = imgproc.bilinear_sample(stack, pos.reshape(-1, 2))  # [S, K*60]
    vals = vals.reshape(len(LADDER), -1, N_POINTS)
    sig = torch.from_numpy(PATTERN_SIGMA).to(dev)[None, :] * scale[:, None]
    ladder = torch.from_numpy(LADDER).to(dev)
    lidx = torch.argmin(torch.abs(torch.log(sig[..., None]) - torch.log(ladder)), dim=-1)
    return torch.gather(vals.permute(1, 2, 0), 2, lidx[..., None])[..., 0]


def brisk_compute(img: torch.Tensor, kp: KeyPoints, pattern_scale: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """512-bit BRISK descriptors of given keypoints: (int32 [K, 16], angle
    [K] rad). A keypoint's pattern scale is size / 12."""
    img = img.to(torch.float32)
    dev = img.device
    stack = _blur_stack(img)
    # a device-tensor divisor: CUDA divides by a Python float as a multiply by
    # its reciprocal, which rounds otherwise than the CPU's and XLA's division
    scale = pattern_scale * torch.clamp(kp.size, min=1.0) / torch.tensor(12.0, device=dev)
    v0 = _sample_pattern(stack, kp.xy, torch.zeros_like(scale), scale)
    li = torch.from_numpy(LONG_PAIRS[:, 0]).to(dev)
    lj = torch.from_numpy(LONG_PAIRS[:, 1]).to(dev)
    pat = torch.from_numpy(PATTERN_XY).to(dev)
    dxy = (pat[lj] - pat[li])[None] * scale[:, None, None]  # [K, L, 2]
    dval = v0[:, lj] - v0[:, li]
    d2 = torch.clamp((dxy * dxy).sum(-1), min=1e-6)
    g = (dxy * (dval / d2)[..., None]).sum(dim=1)
    angle = torch.atan2(g[:, 1], g[:, 0])
    v = _sample_pattern(stack, kp.xy, angle, scale)
    si = torch.from_numpy(SHORT_PAIRS[:, 0]).to(dev)
    sj = torch.from_numpy(SHORT_PAIRS[:, 1]).to(dev)
    return pack_bits(v[:, si] < v[:, sj]), angle


def brisk_detect_and_compute(
    img,
    max_keypoints: int = 512,
    threshold: float = 30.0,
    n_levels: int = 4,
    pattern_scale: float = 1.0,
    device=None,
) -> tuple[KeyPoints, torch.Tensor]:
    """BRISK detect + describe (BRISK::create(thresh=30, octaves=3,
    patternScale=1) analog): (KeyPoints [K], int32 [K, 16]) with K =
    n_levels * (max_keypoints // n_levels). Runs on the card unless
    `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    dev = img.device
    scale_factor = math.sqrt(2.0)
    pyr = pyramid.build_pyramid(img, n_levels, scale_factor)
    per_level = max(1, max_keypoints // n_levels)
    xs, ys, resp, levels, valids = [], [], [], [], []
    for lvl in range(n_levels):
        level_img = pyr.levels[lvl]
        w = level_img.shape[1]
        score = agast.agast_score(level_img, agast.OAST_9_16)
        corner = score > threshold
        corner &= imgproc.nms_2d(torch.where(corner, score, -float("inf")))
        flat = score.reshape(-1)
        idx, keep = masked_top_k(flat, corner.reshape(-1), per_level)
        s = pyr.scales[lvl]
        xs.append((idx % w).float() * s)
        ys.append((idx // w).float() * s)
        resp.append(torch.where(keep, flat[idx], -float("inf")))
        levels.append(torch.full((idx.shape[0],), lvl, dtype=torch.int32, device=dev))
        valids.append(keep)
    level = torch.cat(levels)
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=dev)
    kp = KeyPoints(
        xy=torch.stack([torch.cat(xs), torch.cat(ys)], -1),
        response=torch.cat(resp),
        angle=torch.zeros((level.shape[0],), dtype=torch.float32, device=dev),
        level=level,
        size=12.0 * torch.pow(sf, level.float()),
        valid=torch.cat(valids),
    )
    desc, angle = brisk_compute(img, kp, pattern_scale)
    return KeyPoints(kp.xy, kp.response, angle, kp.level, kp.size, kp.valid), desc
