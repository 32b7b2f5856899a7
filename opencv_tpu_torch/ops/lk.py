"""Pyramidal Lucas-Kanade sparse optical flow (port of opencv_tpu/ops/lk.py).

The analog of cv::calcOpticalFlowPyrLK: per point and pyramid level, a
2x2 gradient normal matrix G over a win x win template window, a
min-eigenvalue gate, and up to `max_iters` Newton steps on the mismatch
vector with the reference's eps and oscillation exits.

The schedule is the JAX package's:

- Levels of at least 90 000 px take the patch-cached path: the templates
  and one 48 x 48 patch of the next image per point are sampled once per
  level, the Newton steps sample the window inside the cached patch
  (bf16 operands, f32 sums), and one f32 polish step samples the full
  image at the converged position. Smaller levels sample the full image
  at every step.
- The JAX package samples those levels' templates, patches and polish
  windows with its Pallas tile kernel on a TPU and with XLA einsums
  elsewhere (`_use_pallas_templates`). The port takes the TPU branch on
  every device, under the same gate: kernel K4 (`ops/cuda/lk_sample.py`,
  csrc/lk_sample.cu) on the card, its plain version on the CPU. Levels
  under the gate keep the dense path, plain PyTorch here as XLA computed
  it outside any kernel.
- After 10 steps the unconverged points are compacted to N/4 and only
  those finish the budget.

The JAX package runs the step loops as `lax.while_loop`s that leave once
every live point has converged. Here each loop is a Python loop of trips
of `_UNROLL` masked steps; before every trip but the first the host reads
one flag (one `.item()` per trip) and leaves when nothing is left to do.
A converged point is a masked no-op, so the trips taken or skipped change
no result; the read only saves the work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.config import LKConfig
from opencv_tpu_torch.core.pyramid import build_lk_pyramid
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.cuda import lk_sample

F32 = torch.float32
BF16 = torch.bfloat16

_PATCH = 48  # target-patch edge; slack = (P - win)/2 - 1 px per level
_UNROLL = 5  # Newton steps per trip of the step loops
_PATCH_MIN_AREA = 90_000  # levels that take the patch-cached path
_KERNEL_MIN_AREA = 90_000  # levels whose windows K4 samples
_KERNEL_MAX_WIN = 23  # the TPU kernel's tile budget, kept as the gate


def _use_sampler_kernel(h: int, w: int, win: int) -> bool:
    """The JAX package's TPU rule (`lk._use_pallas_templates`), on every
    device: K4 samples levels of at least 90 000 px at windows <= 23."""
    return win <= _KERNEL_MAX_WIN and h * w >= _KERNEL_MIN_AREA


def _interp_weights(local_ctr: torch.Tensor, win: int, dim: int, dtype=F32) -> torch.Tensor:
    """Banded bilinear selection matrix [N, win, dim]: row r holds the two
    weights selecting position (local_ctr - win//2 + r); rows out of range
    are zero. In bf16 the fraction and 1 - fraction are rounded to bf16."""
    start = local_ctr - float(win // 2)
    i0 = torch.floor(start)
    f = (start - i0)[:, None, None].to(dtype)
    rows = (i0[:, None] + torch.arange(win, dtype=F32, device=i0.device)[None, :])[:, :, None]
    d = torch.arange(dim, dtype=F32, device=i0.device)[None, None, :]
    zero = torch.zeros((), dtype=dtype, device=i0.device)
    return torch.where(d == rows, 1.0 - f, zero) + torch.where(d == rows + 1.0, f, zero)


def _sample_at(chans: torch.Tensor, pts: torch.Tensor, win: int, wdtype=F32) -> torch.Tensor:
    """Dense bilinear windows of chans [C, H, W] at pts [N, 2] ->
    [C, N, win, win]: the XLA banded einsum (`lk._sample_at`) as a gather
    of its two non-zero taps, rows first and then columns; a tap outside
    the image has weight 0. With wdtype bf16 the weights and the image are
    rounded to bf16 and each contraction's result is rounded to bf16, as
    the bf16 einsum does (its products are exact in f32)."""
    c, h, w = chans.shape
    src = chans if chans.dtype == wdtype else chans.to(wdtype)
    start = pts.to(F32) - float(win // 2)
    i0 = torch.floor(start)
    f = (start - i0).to(wdtype)
    base = torch.nan_to_num(i0, nan=-1e6, posinf=1e6, neginf=-1e6).clamp(-1e6, 1e6).to(torch.int64)
    ar = torch.arange(win + 1, device=pts.device)
    ry = base[:, 1, None] + ar  # [N, win+1]
    rx = base[:, 0, None] + ar
    vy = (ry >= 0) & (ry < h)
    vx = (rx >= 0) & (rx < w)
    zero = torch.zeros((), dtype=wdtype, device=pts.device)
    lo, hi = 1.0 - f, f
    wy0 = torch.where(vy[:, :win], lo[:, 1, None], zero).to(F32)[:, :, None]
    wy1 = torch.where(vy[:, 1:], hi[:, 1, None], zero).to(F32)[:, :, None]
    wx0 = torch.where(vx[:, :win], lo[:, 0, None], zero).to(F32)[:, None, :]
    wx1 = torch.where(vx[:, 1:], hi[:, 0, None], zero).to(F32)[:, None, :]
    idx = ry.clamp(0, h - 1)[:, :, None] * w + rx.clamp(0, w - 1)[:, None, :]
    taps = src.reshape(c, h * w)[:, idx].to(F32)  # [C, N, win+1, win+1]
    tmp = wy0 * taps[:, :, :win] + wy1 * taps[:, :, 1:]  # [C, N, win, win+1]
    if wdtype != F32:
        tmp = tmp.to(wdtype).to(F32)
    out = wx0 * tmp[..., :win] + wx1 * tmp[..., 1:]
    return out if wdtype == F32 else out.to(wdtype)


def _extract_patches(channels: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, p: int) -> torch.Tensor:
    """[C, H, W] (bf16) + [N] patch origins -> [C, N, p, p] f32: the exact
    row gather and one-hot column selection of the JAX function."""
    c, h, w = channels.shape
    ar = torch.arange(p, device=channels.device)
    ry = y0.to(torch.int64)[:, None] + ar
    rx = x0.to(torch.int64)[:, None] + ar
    return channels.reshape(c, h * w)[:, ry[:, :, None] * w + rx[:, None, :]].to(F32)


class _Tmpl(NamedTuple):
    """Prev-side level state: template windows, gradient normal matrix and
    the min-eigenvalue gate."""

    iw: torch.Tensor  # [N, win, win] template intensities
    ix: torch.Tensor  # [N, win, win] template x-gradients
    iy: torch.Tensor  # [N, win, win] template y-gradients
    gxx: torch.Tensor  # [N]
    gxy: torch.Tensor
    gyy: torch.Tensor
    safe_det: torch.Tensor
    min_eig: torch.Tensor
    ok: torch.Tensor

    def take(self, sel: torch.Tensor) -> "_Tmpl":
        return _Tmpl(*(x[sel] for x in self))


def _level_templates(prev_img, dx, dy, base_pts, cfg: LKConfig) -> _Tmpl:
    """Template windows of (image, dx, dy) at base_pts, then G and the gate."""
    win = cfg.win_size
    area = float(win * win)
    h, w = prev_img.shape
    if _use_sampler_kernel(h, w, win):
        iw, ix, iy = lk_sample.sample_templates(prev_img, dx, dy, base_pts, win)
    else:
        iw, ix, iy = _sample_at(torch.stack([prev_img, dx, dy]), base_pts, win)
    gxx = (ix * ix).sum((1, 2))
    gxy = (ix * iy).sum((1, 2))
    gyy = (iy * iy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))) * 0.5 / area
    ok = min_eig > cfg.min_eig_threshold
    safe_det = torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
    return _Tmpl(iw, ix, iy, gxx, gxy, gyy, safe_det, min_eig, ok)


def _solve(t: _Tmpl, jw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(delta [N, 2], diff [N, win, win]) of one Newton step from a J sample."""
    diff = t.iw - jw
    bx = (diff * t.ix).sum((1, 2))
    by = (diff * t.iy).sum((1, 2))
    d_x = (t.gyy * bx - t.gxy * by) / t.safe_det
    d_y = (t.gxx * by - t.gxy * bx) / t.safe_det
    return torch.stack([d_x, d_y], dim=-1), diff


def _one_step(delta, g, conv, prev_delta, active, eps: float, clamp=None):
    """One Newton update with the reference's two exits
    (lkpyramid.cpp:642-651): eps on |delta|^2, and the oscillation break
    (delta ~ -prevDelta: step back half and stop)."""
    osc = ((delta[:, 0] + prev_delta[:, 0]).abs() < 0.01) & (
        (delta[:, 1] + prev_delta[:, 1]).abs() < 0.01)
    do_update = (active & ~conv)[:, None]
    eff = torch.where(osc[:, None], 0.5 * delta, delta)
    new = g + eff
    if clamp is not None:
        new = clamp(new)
    g = torch.where(do_update, new, g)
    step = (delta * delta).sum(-1)
    conv = conv | (step <= eps * eps) | osc
    return g, conv, delta


def _iterate(t: _Tmpl, g0, sample, cfg: LKConfig, clamp=None):
    """The two step loops shared by the patch and the dense path.

    `sample(g, sel)` returns the J windows at g for the points `sel`
    (None: all). Phase 1 runs min(10, max_iters) steps over all points;
    then the unconverged ones are compacted to min(N, max(N/4, 32)) slots
    and only those finish the budget. Returns the final positions."""
    n = g0.shape[0]
    big0 = torch.full((n, 2), 1e9, dtype=F32, device=g0.device)

    def run(tt, g, conv, prev, active, sel, trips):
        for trip in range(trips):
            # one host read per trip but the first: leave once every
            # active point has converged (the while_loop's condition)
            if trip and bool((conv | ~active).all()):
                break
            for _ in range(_UNROLL):
                delta, _ = _solve(tt, sample(g, sel))
                g, conv, prev = _one_step(delta, g, conv, prev, active, cfg.eps, clamp)
        return g, conv

    phase1 = min(10, cfg.max_iters)
    g, conv = run(t, g0, torch.zeros(n, dtype=torch.bool, device=g0.device), big0, t.ok,
                  None, -(-phase1 // _UNROLL))

    cap = min(n, max(n // 4, 32))
    live = t.ok & ~conv
    sel, keep = masked_top_k(live.to(F32), live, cap)
    trips2 = -(-(cfg.max_iters - phase1) // _UNROLL)
    # the loop's first condition, read here: is any point left to finish
    if trips2 > 0 and bool(live.any()):
        g_sub, _ = run(t.take(sel), g[sel], ~live[sel] | ~keep, big0[:cap], keep, sel, trips2)
        g = g.clone()
        g[sel] = torch.where(keep[:, None], g_sub, g[sel])
    return g


def _patch_origin(guess_pts, h: int, w: int):
    """Integer patch origins around the level-entry guesses and the f32
    offset (x, y) from patch-local to image coordinates."""
    p = _PATCH
    jy0 = torch.clamp(torch.round(guess_pts[:, 1]).to(torch.int64) - p // 2, 0, h - p)
    jx0 = torch.clamp(torch.round(guess_pts[:, 0]).to(torch.int64) - p // 2, 0, w - p)
    return jy0, jx0, torch.stack([jx0, jy0], dim=-1).to(F32)


def _patch_iterate(t: _Tmpl, next_patch, joff, guess_pts, next_img, cfg: LKConfig):
    """Newton loops on the cached patch, then one f32 polish step on the
    full image (K4 under the gate). Returns (guess, min_eig, residual)."""
    win = cfg.win_size
    p = _PATCH
    half = win // 2
    lo_lim, hi_lim = float(half), float(p - half - 2)

    def clamp_local(g):
        return g.clamp(lo_lim, hi_lim)

    patches = next_patch.to(BF16).to(F32)

    def sample_j(g_loc, sel):
        # bf16 weights and patch, f32 sums, the row pass rounded to bf16
        # between the two products (lk.py sample_j)
        pb = patches if sel is None else patches[sel]
        g_loc = clamp_local(g_loc)
        wy = _interp_weights(g_loc[:, 1], win, p, BF16).to(F32)
        wx = _interp_weights(g_loc[:, 0], win, p, BF16).to(F32)
        tmp = torch.bmm(wy, pb).to(BF16).to(F32)
        return torch.bmm(tmp, wx.transpose(1, 2))

    g_loc = _iterate(t, clamp_local(guess_pts - joff), sample_j, cfg, clamp=clamp_local)

    guess = g_loc + joff
    if _use_sampler_kernel(next_img.shape[0], next_img.shape[1], win):
        jw = lk_sample.sample_single(next_img, guess, win)
    else:
        jw = _sample_at(next_img[None], guess, win)[0]
    delta, diff = _solve(t, jw)
    guess = torch.where(t.ok[:, None], guess + delta, guess)
    return guess, t.min_eig, diff.abs().mean((1, 2))


def _track_level_patch(prev_img, next_img, dx, dy, base_pts, guess_pts, cfg: LKConfig):
    """Patch-cached LK level: templates once, one 48 x 48 patch of the next
    image per point (K4 at frac 0 under the gate, rounded through bf16 to
    equal the exact bf16 gather), Newton steps inside the patch, polish.
    Returns (guess, min_eig, residual)."""
    h, w = prev_img.shape
    t = _level_templates(prev_img, dx, dy, base_pts, cfg)
    jy0, jx0, joff = _patch_origin(guess_pts, h, w)
    if _use_sampler_kernel(h, w, cfg.win_size):
        ctr = torch.stack([jx0, jy0], dim=-1).to(F32) + float(_PATCH // 2)
        next_patch = lk_sample.sample_single(next_img, ctr, _PATCH).to(BF16).to(F32)
    else:
        next_patch = _extract_patches(next_img.to(BF16)[None], jy0, jx0, _PATCH)[0]
    return _patch_iterate(t, next_patch, joff, guess_pts, next_img, cfg)


def _dense_iterate(t: _Tmpl, next_img, guess_pts, cfg: LKConfig):
    """Newton loops + polish with dense full-image sampling (levels smaller
    than the patch path's). Returns (guess, min_eig, residual)."""
    win = cfg.win_size
    next_bf = next_img.to(BF16)[None]

    def sample(g, sel):
        return _sample_at(next_bf, g, win, BF16)[0]

    guess = _iterate(t, guess_pts, sample, cfg)
    delta, diff = _solve(t, _sample_at(next_img[None], guess, win)[0])
    guess = torch.where(t.ok[:, None], guess + delta, guess)
    return guess, t.min_eig, diff.abs().mean((1, 2))


def _track_level_dense(prev_img, next_img, dx, dy, base_pts, guess_pts, cfg: LKConfig):
    """One pyramid level of LK with dense full-image sampling."""
    t = _level_templates(prev_img, dx, dy, base_pts, cfg)
    return _dense_iterate(t, next_img, guess_pts, cfg)


def _use_patch(h: int, w: int) -> bool:
    return min(h, w) >= _PATCH and h * w >= _PATCH_MIN_AREA


def _track_level(prev_img, next_img, dx, dy, base_pts, guess_pts, cfg: LKConfig):
    """Patch-cached path on large levels, dense sampling on small ones."""
    h, w = prev_img.shape
    track = _track_level_patch if _use_patch(h, w) else _track_level_dense
    return track(prev_img, next_img, dx, dy, base_pts, guess_pts, cfg)


def build_flow_pyramid(img, cfg: LKConfig = LKConfig(), device=None):
    """cv::buildOpticalFlowPyramid analog: a tuple of (level, dx, dy) per
    level, finest first, with Scharr derivatives; reusable across calls.
    A batch [F, H, W] gives stacked levels [F, h, w] (the input of
    `calc_optical_flow_pyr_lk_pairs`). Runs on the card unless
    `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(F32)
    out = []
    for lvl_img in build_lk_pyramid(img, cfg.n_levels).levels:
        dx, dy = imgproc.scharr_derivatives(lvl_img)
        out.append((lvl_img, dx, dy))
    return tuple(out)


def _as_points(pts, pts_valid, dev):
    pts = torch.as_tensor(pts, dtype=F32, device=dev)
    if pts_valid is None:
        pts_valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=dev)
    return pts, torch.as_tensor(pts_valid, dtype=torch.bool, device=dev)


def _inside(guess, h: int, w: int):
    return ((guess[..., 0] >= 0.0) & (guess[..., 0] <= w - 1.0)
            & (guess[..., 1] >= 0.0) & (guess[..., 1] <= h - 1.0))


def calc_optical_flow_pyr_lk_pyr(pyr_prev, pyr_next, pts, pts_valid=None,
                                 cfg: LKConfig = LKConfig()):
    """LK on prebuilt `build_flow_pyramid` outputs (the pyramid-reuse
    path), on their device. Returns (new_pts [N, 2], status [N] bool,
    err [N] f32 mean absolute window residual)."""
    lvl0 = pyr_prev[0][0]
    h, w = lvl0.shape
    pts, status = _as_points(pts, pts_valid, lvl0.device)
    top = cfg.n_levels - 1
    guess = pts / (2.0 ** top)
    err = None
    for lvl in range(top, -1, -1):
        p_img, dx, dy = pyr_prev[lvl]
        guess, min_eig, err = _track_level(p_img, pyr_next[lvl][0], dx, dy,
                                           pts / (2.0 ** lvl), guess, cfg)
        if lvl > 0:
            guess = guess * 2.0
        else:
            # the min-eig gate applies at full resolution
            status = status & (min_eig > cfg.min_eig_threshold)
    return guess, status & _inside(guess, h, w), err


def calc_optical_flow_pyr_lk(prev_img, next_img, pts, pts_valid=None,
                             cfg: LKConfig = LKConfig(), device=None):
    """cv::calcOpticalFlowPyrLK analog. pts [N, 2] (x, y) in prev_img
    coordinates. Returns (new_pts [N, 2], status [N] bool, err [N] f32).
    Runs on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    pyr_prev = build_flow_pyramid(prev_img, cfg, dev)
    pyr_next = build_flow_pyramid(next_img, cfg, dev)
    return calc_optical_flow_pyr_lk_pyr(pyr_prev, pyr_next, pts, pts_valid, cfg)


def calc_optical_flow_pyr_lk_pairs(stacked_pyrs, pts, pts_valid=None,
                                   cfg: LKConfig = LKConfig()):
    """Track every consecutive frame pair of a clip: stacked_pyrs is
    `build_flow_pyramid` of frames [F, H, W]; pts [F-1, N, 2] are points in
    frame t to track into frame t+1, pts_valid [F-1, N]. Returns stacked
    (new_pts [F-1, N, 2], status [F-1, N], err [F-1, N]).

    The JAX function vmaps the templates and patches over the pairs (with
    the XLA sampler: a Pallas call does not vmap) and scans the Newton
    loops. Pairs carry no state, so here a loop runs the pyramid-reuse
    path on each pair, with its samplers."""
    pts, pts_valid = _as_points(pts, pts_valid, stacked_pyrs[0][0].device)
    outs = []
    for i in range(pts.shape[0]):
        prev = tuple(tuple(a[i] for a in lvl) for lvl in stacked_pyrs)
        nxt = tuple(tuple(a[i + 1] for a in lvl) for lvl in stacked_pyrs)
        outs.append(calc_optical_flow_pyr_lk_pyr(prev, nxt, pts[i], pts_valid[i], cfg))
    return tuple(torch.stack(x) for x in zip(*outs))
