"""ORB: oriented FAST + rotated BRIEF over a scale pyramid (port of
opencv_tpu/ops/orb.py `detect_and_compute`).

FAST score + NMS of all levels (kernel K1 on the card, one launch per
frame), then per level: border mask ->
cull to 2x budget by FAST score -> Harris rescoring -> cull to budget ->
quadratic sub-pixel refine -> intensity-centroid angle -> 7x7 Gaussian
blur -> rotated BRIEF by an exact per-keypoint gather. The JAX package's
"binned" matmul BRIEF is a TPU workaround for slow gathers and an
approximation; the port always takes the exact gather.

Descriptors are int32 [N, 8] tensors carrying the bit pattern of the JAX
package's uint32 words.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc, pyramid as pyr_mod
from opencv_tpu_torch.core.config import ORBConfig
from opencv_tpu_torch.core.types import KeyPoints, masked_top_k
from opencv_tpu_torch.ops import fast as fast_mod
from opencv_tpu_torch.ops.matching import pack_bits

HALF_PATCH = 15  # orientation patch radius
PATTERN_BITS = 256
PATTERN_RADIUS = 13
PATCH_RADIUS = 20


@functools.cache
def brief_pattern() -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2): the fixed-seed Gaussian BRIEF
    pattern, drawn exactly as opencv_tpu.ops.orb.brief_pattern draws it."""
    rng = np.random.default_rng(8823)
    sigma = (2 * PATTERN_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(PATTERN_BITS, 4))
    pts = np.clip(np.round(pts), -PATTERN_RADIUS, PATTERN_RADIUS).astype(np.int32)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] = np.clip(pts[same, 2] + 1, -PATTERN_RADIUS, PATTERN_RADIUS)
    pts[same, 3] = np.clip(pts[same, 3] - 1, -PATTERN_RADIUS, PATTERN_RADIUS)
    return pts


def ic_angle_maps(img: torch.Tensor, radius: int = HALF_PATCH) -> torch.Tensor:
    """Dense (m01, m10) circular moments -> per-pixel angle map [H, W], from
    shifted reads of two prefix-sum images (as the JAX function)."""
    img = img.to(torch.float32)
    h, w = img.shape
    r = radius
    ext = [int(math.floor(math.sqrt(r * r - t * t))) for t in range(-r, r + 1)]
    ix = torch.cumsum(F.pad(img, (r + 1, r, r, r)), dim=1)  # [h+2r, w+2r+1]
    m01 = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for i, v in enumerate(range(-r, r + 1)):
        if v == 0:
            continue
        u = ext[i]
        hi = ix[r + v : r + v + h, r + 1 + u : r + 1 + u + w]
        lo = ix[r + v : r + v + h, r - u : r - u + w]
        m01 = m01 + float(v) * (hi - lo)
    iy = torch.cumsum(F.pad(img, (r, r, r + 1, r)), dim=0)
    m10 = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for i, u in enumerate(range(-r, r + 1)):
        if u == 0:
            continue
        v = ext[i]
        hi = iy[r + 1 + v : r + 1 + v + h, r + u : r + u + w]
        lo = iy[r - v : r - v + h, r + u : r + u + w]
        m10 = m10 + float(u) * (hi - lo)
    return torch.atan2(m01, m10)


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint, radians."""
    amap = ic_angle_maps(img)
    h, w = img.shape
    xi = torch.round(xy[:, 0]).long().clamp(0, w - 1)
    yi = torch.round(xy[:, 1]).long().clamp(0, h - 1)
    return amap[yi, xi]


def brief_descriptors(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotated 256-bit BRIEF: each tap is rotated by the keypoint angle,
    rounded to the nearest pixel of the blurred level, and pairs compared
    (computeOrbDescriptors WTA_K=2). int32 [N, 8]."""
    dev = blurred.device
    pat = torch.as_tensor(brief_pattern(), device=dev)
    px = torch.cat([pat[:, 0], pat[:, 2]]).to(torch.float32)
    py = torch.cat([pat[:, 1], pat[:, 3]]).to(torch.float32)
    cos = torch.cos(angle)[:, None]
    sin = torch.sin(angle)[:, None]
    rx = torch.round(px[None] * cos - py[None] * sin).long()
    ry = torch.round(px[None] * sin + py[None] * cos).long()
    h, w = blurred.shape
    cx = torch.round(xy[:, 0:1]).long()
    cy = torch.round(xy[:, 1:2]).long()
    xi = (cx + rx).clamp(0, w - 1)
    yi = (cy + ry).clamp(0, h - 1)
    vals = blurred.reshape(-1)[yi * w + xi]  # [N, 512]
    return pack_bits(vals[:, :PATTERN_BITS] < vals[:, PATTERN_BITS:])


def subpixel_refine(score: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Separable quadratic peak refinement of integer keypoint positions
    on the score map (offsets clipped to +-0.5)."""
    h, w = score.shape
    xi = torch.round(xy[:, 0]).long().clamp(1, w - 2)
    yi = torch.round(xy[:, 1]).long().clamp(1, h - 2)

    def axis_offset(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        safe = torch.where(denom.abs() > 1e-9, denom, torch.ones_like(denom))
        off = torch.where(denom.abs() > 1e-9, 0.5 * (sm - sp) / safe, torch.zeros_like(denom))
        return off.clamp(-0.5, 0.5)

    s0 = score[yi, xi]
    dx = axis_offset(score[yi, xi - 1], s0, score[yi, xi + 1])
    dy = axis_offset(score[yi - 1, xi], s0, score[yi + 1, xi])
    return xy + torch.stack([dx, dy], dim=-1)


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Geometric per-level feature budget (orb.cpp:798-808)."""
    factor = 1.0 / scale_factor
    first = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    budgets, acc = [], 0
    for lvl in range(n_levels - 1):
        b = int(round(first * factor ** lvl))
        budgets.append(b)
        acc += b
    budgets.append(max(n_features - acc, 0))
    return budgets


def detect_and_compute(
    img: torch.Tensor, config: ORBConfig = ORBConfig()
) -> tuple[KeyPoints, torch.Tensor]:
    """Full ORB pipeline on one f32 [H, W] image. Returns (KeyPoints,
    descriptors int32 [N, 8]) with N = sum of the per-level budgets."""
    img = img.to(torch.float32)
    dev = img.device
    pyr = pyr_mod.build_pyramid(img, config.n_levels, config.scale_factor)
    budgets = level_budgets(config.n_features, config.n_levels, config.scale_factor)
    border = max(config.edge_threshold, PATCH_RADIUS + 1)

    # FAST + NMS of every level with a budget: one kernel launch on the card
    used = [lvl for lvl in range(config.n_levels) if budgets[lvl] > 0]
    fast = fast_mod.fast_corners_levels([pyr.levels[lvl] for lvl in used], config.fast_threshold)

    all_kp: list[KeyPoints] = []
    all_desc: list[torch.Tensor] = []
    for lvl, (score, corner) in zip(used, fast):
        level = pyr.levels[lvl]
        scale = pyr.scales[lvl]
        budget = budgets[lvl]
        h, w = level.shape
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        corner &= (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)

        # stage 1: cull to 2x budget by FAST score
        n_cand = min(2 * budget, h * w)
        cand_idx, cand_keep = masked_top_k(score.reshape(-1), corner.reshape(-1), n_cand)
        cxy = torch.stack([(cand_idx % w).float(), (cand_idx // w).float()], dim=-1)

        # stage 2: Harris rescoring + final cull (the ranking decides the slot
        # order, so the block sums follow JAX's order: see box_sum_integral)
        harris = imgproc.harris_response(level, block_size=config.harris_block)
        cand_harris = harris.reshape(-1)[cand_idx]
        sel, keep = masked_top_k(cand_harris, cand_keep, budget)
        xy = subpixel_refine(score, cxy[sel])
        resp = torch.where(keep, cand_harris[sel], -float("inf"))

        angle = ic_angles(level, xy)
        blurred = imgproc.gaussian_blur(level, 7, 2.0)
        desc = brief_descriptors(blurred, xy, angle)

        n = sel.shape[0]
        all_kp.append(KeyPoints(
            xy=xy * scale,
            response=resp,
            angle=angle,
            level=torch.full((n,), lvl, dtype=torch.int32, device=dev),
            size=torch.full((n,), config.patch_size * scale, dtype=torch.float32, device=dev),
            valid=keep,
        ))
        all_desc.append(desc)
    return KeyPoints.concatenate(all_kp), torch.cat(all_desc, dim=0)
