"""Haar and LBP cascade object detection (port of opencv_tpu/ops/cascade.py).

Reference: CPU cascades (objdetect/src/cascadedetect.cpp,
cascadedetect.hpp:356 HaarEvaluator, :570 predictOrderedStump), the GPU
NCV implementation (cudalegacy/src/cuda/NCVHaarObjectDetection.cu);
trained models ship as XML (data/haarcascades*, data/lbpcascades).

Normalization matches the reference (cascadedetect.cpp:717
HaarEvaluator::setWindow): the window statistic is taken over the NORM
RECT (the window inset by 1 px), nf = sqrt(narea*sqsum - sum^2), each
stump's feature value is its weighted rect sum / nf, and windows with
narea/nf >= 0.1 (flat texture) are rejected outright.

The JAX design is kept. Haar: the first `dense_stages` stages run densely
over every window position (a stage's rect sums as one gather of their
four integral-image corners, where JAX slices rect by rect), the survivors are compacted to a fixed capacity
(`masked_top_k`, a stable sort: ties keep the lower index, as
`lax.top_k`), and the remaining stages run as batched integral-image
gathers over the survivors with the early exit carried as an alive
mask. LBP: every stage densely; the 16 grid corners of every feature are
one broadcast gather (chunked over features to bound its memory), the
8-bit codes follow LBPEvaluator::calc's bit order, and each stump's
256-bit subset is a [256] table of its two leaf values.

Orders of the float sums follow the JAX functions: the dense stages add
stump by stump, the gathered stages' sums over rect corners and stumps
take `imgproc.xla_sum` (XLA's reduction order), LBP's stage sums add
stump by stump (XLA's CPU scatter adds updates in order). The integral
images are `imgproc.integral` (eager JAX's prefix-sum order). So the
score maps equal eager JAX's bit for bit on either device.

`detect_multi_scale` and `detect_multi_scale_lbp` read the hits of all
scales from the device once per image (the JAX functions read each
scale) and group them on the host (`group_rectangles`, numpy).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.device import on_device


class CascadeModel(NamedTuple):
    """Stump-based Haar cascade (numpy fields, as the JAX package's).

    window: (h, w) base window.
    rects: [F, 3, 5] up to 3 weighted rects (x, y, w, h, weight) per feature.
    feature [S] i32, threshold/left/right [S] f32: the stumps.
    stage_offsets: [n_stages + 1] i32 — stumps of stage s are
      [offsets[s], offsets[s+1]).
    stage_thresholds: [n_stages] f32.
    """

    window: tuple[int, int]
    rects: np.ndarray
    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    stage_offsets: np.ndarray
    stage_thresholds: np.ndarray


def load_opencv_cascade(path: str) -> CascadeModel:
    """Parse a modern-format OpenCV Haar cascade XML (stumps, no tilted
    features)."""
    root = ET.parse(path).getroot()
    c = root.find("cascade")
    if c is None:
        raise ValueError("old-format cascade not supported")
    if (c.findtext("featureType") or "HAAR").strip() != "HAAR":
        raise ValueError("only HAAR cascades here; LBP: load_opencv_lbp_cascade")
    wh = (int(c.findtext("height")), int(c.findtext("width")))
    feats = []
    for f in c.find("features"):
        tilted = f.findtext("tilted")
        if tilted is not None and tilted.strip() == "1":
            raise ValueError("tilted Haar features not supported")
        rects = np.zeros((3, 5), np.float32)
        for i, r in enumerate(f.find("rects")):
            vals = r.text.split()
            rects[i] = [float(v) for v in vals[:4]] + [float(vals[4])]
        feats.append(rects)
    feature, threshold, left, right = [], [], [], []
    offsets, thresholds = [0], []
    for stage in c.find("stages"):
        thresholds.append(float(stage.findtext("stageThreshold")))
        for wc in stage.find("weakClassifiers"):
            inter = wc.findtext("internalNodes").split()
            if len(inter) != 4:
                raise ValueError("tree-based cascade not supported (stumps only)")
            leaf = wc.findtext("leafValues").split()
            feature.append(int(inter[2]))
            threshold.append(float(inter[3]))
            left.append(float(leaf[0]))
            right.append(float(leaf[1]))
        offsets.append(len(feature))
    return CascadeModel(
        window=wh,
        rects=np.stack(feats),
        feature=np.asarray(feature, np.int32),
        threshold=np.asarray(threshold, np.float32),
        left=np.asarray(left, np.float32),
        right=np.asarray(right, np.float32),
        stage_offsets=np.asarray(offsets, np.int32),
        stage_thresholds=np.asarray(thresholds, np.float32),
    )


# ---------------------------------------------------------------- tensors


class _StageTensors(NamedTuple):
    """Stage-padded stump tensors (T stages, Smax stumps per stage). Each
    stump reads up to 12 integral-image corners (3 rects x 4): corner
    value ii[y + dy, x + dx] weighted by w (0 = unused)."""

    dy: torch.Tensor  # [T, Smax, 12] i64
    dx: torch.Tensor  # [T, Smax, 12] i64
    w: torch.Tensor  # [T, Smax, 12] f32
    thr: torch.Tensor  # [T, Smax]
    left: torch.Tensor  # [T, Smax] (0 where padded)
    right: torch.Tensor  # [T, Smax]
    stage_thr: torch.Tensor  # [T]


def _stage_tensors(model: CascadeModel, device) -> _StageTensors:
    T = len(model.stage_thresholds)
    smax = int(np.diff(model.stage_offsets).max())
    dy = np.zeros((T, smax, 12), np.int64)
    dx = np.zeros((T, smax, 12), np.int64)
    w = np.zeros((T, smax, 12), np.float32)
    thr = np.zeros((T, smax), np.float32)
    left = np.zeros((T, smax), np.float32)
    right = np.zeros((T, smax), np.float32)
    for s in range(T):
        for k, g in enumerate(range(model.stage_offsets[s], model.stage_offsets[s + 1])):
            fidx = int(model.feature[g])
            thr[s, k], left[s, k], right[s, k] = model.threshold[g], model.left[g], model.right[g]
            for r in range(3):
                x0, y0, rw, rh, wt = model.rects[fidx, r]
                if wt == 0.0:
                    continue
                x0, y0, rw, rh = int(x0), int(y0), int(rw), int(rh)
                base = 4 * r
                dy[s, k, base:base + 4] = [y0 + rh, y0, y0 + rh, y0]
                dx[s, k, base:base + 4] = [x0 + rw, x0 + rw, x0, x0]
                w[s, k, base:base + 4] = [wt, -wt, -wt, wt]

    def t(a):
        return torch.from_numpy(a).to(device)

    return _StageTensors(dy=t(dy), dx=t(dx), w=t(w), thr=t(thr), left=t(left), right=t(right),
                         stage_thr=t(np.asarray(model.stage_thresholds, np.float32)))


def _window_sums(ii: torch.Tensor, y0, x0, h, w, out_h, out_w) -> torch.Tensor:
    """Rect sums for all window origins: [out_h, out_w]."""
    return (
        ii[y0 + h:y0 + h + out_h, x0 + w:x0 + w + out_w]
        - ii[y0 + h:y0 + h + out_h, x0:x0 + out_w]
        - ii[y0:y0 + out_h, x0 + w:x0 + w + out_w]
        + ii[y0:y0 + out_h, x0:x0 + out_w]
    )


def _norm_map(ii, ii2, wh, ww, out_h, out_w):
    """Variance normalization over the NORM RECT (cascadedetect.cpp:623,
    731). Returns (inv_nf, texture_ok): inv_nf = 1/(narea*std);
    texture_ok False where std <= 10 (flat)."""
    narea = float((wh - 2) * (ww - 2))
    s1 = _window_sums(ii, 1, 1, wh - 2, ww - 2, out_h, out_w)
    s2 = _window_sums(ii2, 1, 1, wh - 2, ww - 2, out_h, out_w)
    nf2 = narea * s2 - s1 * s1
    # f64 sqrt rounded to f32 is the correctly rounded f32 sqrt (XLA's) on either device
    nf = torch.sqrt(nf2.clamp_min(1e-12).double()).to(torch.float32)
    inv_nf = torch.where(nf2 > 0, torch.ones_like(nf) / nf, torch.ones_like(nf))
    return inv_nf, (nf2 > 0) & (narea * inv_nf < 0.1)


class _DenseStage(NamedTuple):
    """One stage's stumps for the dense evaluation: the (y, x) offsets of
    the four corners of each stump's three rects (unused rects: weight 0,
    an empty rect at the origin), in `_window_sums`' order."""

    cy: torch.Tensor  # [4, S, 3, 1, 1] i64: (y0+h, y0+h, y0, y0)
    cx: torch.Tensor  # [4, S, 3, 1, 1] i64: (x0+w, x0, x0+w, x0)
    w: torch.Tensor  # [S, 3, 1, 1] f32
    thr: torch.Tensor  # [S, 1, 1]
    left: torch.Tensor  # [S, 1, 1]
    right: torch.Tensor  # [S, 1, 1]
    stage_thr: float


def _dense_tables(model: CascadeModel, n_stages: int, device) -> list:
    out = []
    for s in range(n_stages):
        ks = range(int(model.stage_offsets[s]), int(model.stage_offsets[s + 1]))
        r = model.rects[model.feature[list(ks)]]  # [S, 3, 5]
        x0, y0, rw, rh = (r[..., i].astype(np.int64) for i in range(4))
        cy = np.stack([y0 + rh, y0 + rh, y0, y0])[..., None, None]
        cx = np.stack([x0 + rw, x0, x0 + rw, x0])[..., None, None]

        def t(a, shape=(-1, 1, 1)):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device).reshape(shape)

        out.append(_DenseStage(t(cy, cy.shape), t(cx, cx.shape), t(r[..., 4], (len(ks), 3, 1, 1)),
                               t(model.threshold[list(ks)]), t(model.left[list(ks)]),
                               t(model.right[list(ks)]), float(model.stage_thresholds[s])))
    return out


def _feature_values(ii, inv_nf, st: _DenseStage, out_h, out_w) -> torch.Tensor:
    """[S, oh, ow] normalized feature values of a stage's stumps at every
    window origin: every rect sum as one gather of its four corners, then
    the JAX function's order: ((D - C) - B) + A per rect, the weighted
    rects added rect by rect (an unused rect adds 0), times 1/nf."""
    yy = torch.arange(out_h, device=ii.device)[:, None]
    xx = torch.arange(out_w, device=ii.device)[None, :]
    c = ii[st.cy + yy, st.cx + xx]  # [4, S, 3, oh, ow]
    wsum = st.w * (((c[0] - c[1]) - c[2]) + c[3])
    fsum = torch.zeros(wsum.shape[:1] + wsum.shape[2:], dtype=torch.float32, device=ii.device)
    for r in range(3):
        fsum = fsum + wsum[:, r]
    return fsum * inv_nf


def _dense_stages(ii, inv_nf, accept, stages: list, out_h, out_w):
    """The given stages densely over every window origin; the stump values
    added stump by stump, as the JAX function adds them."""
    dev = ii.device
    for st in stages:
        vals = torch.where(_feature_values(ii, inv_nf, st, out_h, out_w) < st.thr, st.left, st.right)
        stage_sum = torch.zeros((out_h, out_w), dtype=torch.float32, device=dev)
        for k in range(vals.shape[0]):
            stage_sum = stage_sum + vals[k]
        accept = accept & (stage_sum >= st.stage_thr)
    return accept


def _integrals(img: torch.Tensor):
    img = img.to(torch.float32)
    return imgproc.integral(img), imgproc.integral(img * img)


def cascade_score_map(img, model: CascadeModel, n_stages: int | None = None,
                      device=None) -> torch.Tensor:
    """Dense cascade evaluation at the model's native scale over the
    first `n_stages` stages (all by default). Returns the acceptance
    mask [H - wh + 1, W - ww + 1]. A tensor image stays on its device;
    numpy goes to the card unless `device="cpu"`."""
    img = on_device(img, device).to(torch.float32)
    wh, ww = model.window
    h, w = img.shape
    out_h, out_w = h - wh + 1, w - ww + 1
    ii, ii2 = _integrals(img)
    inv_nf, accept = _norm_map(ii, ii2, wh, ww, out_h, out_w)
    total = len(model.stage_thresholds)
    stages = _dense_tables(model, total if n_stages is None else min(n_stages, total), img.device)
    return _dense_stages(ii, inv_nf, accept, stages, out_h, out_w)


def _eval_stages_gather(ii, by, bx, inv_nf_w, alive, t: _StageTensors, start: int):
    """Stages [start, T) for the window set (by, bx) by batched
    integral-image gathers; the early exit is carried as the alive mask
    (every stage runs, as the JAX scan)."""
    for s in range(start, t.dy.shape[0]):
        vals = ii[by[:, None, None] + t.dy[s][None], bx[:, None, None] + t.dx[s][None]]
        fsum = imgproc.xla_sum(vals * t.w[s][None])  # [M, Smax]
        pred = fsum * inv_nf_w[:, None] < t.thr[s][None, :]
        ssum = imgproc.xla_sum(torch.where(pred, t.left[s][None, :], t.right[s][None, :]))
        alive = alive & (ssum >= t.stage_thr[s])
    return alive


def _detect_one_scale(img, t: _StageTensors, dense: list, model: CascadeModel, capacity: int):
    """(by, bx, alive) of one scale: the `dense` stages, compaction of the
    survivors to `capacity`, the other stages gathered."""
    wh, ww = model.window
    h, w = img.shape
    out_h, out_w = h - wh + 1, w - ww + 1
    ii, ii2 = _integrals(img)
    inv_nf, accept = _norm_map(ii, ii2, wh, ww, out_h, out_w)
    dense_stages = len(dense)
    accept = _dense_stages(ii, inv_nf, accept, dense, out_h, out_w)
    flat = accept.reshape(-1)
    idx, kmask = masked_top_k(flat.to(torch.float32), flat, min(capacity, out_h * out_w))
    by, bx = idx // out_w, idx % out_w
    alive = _eval_stages_gather(ii, by, bx, inv_nf[by, bx], kmask, t, dense_stages)
    return by, bx, alive


def _scales(h: int, w: int, window, scale0: float, n_scales: int):
    """(index, scale, scaled h, scaled w) of each pyramid level while the
    window (plus 2 px) still fits."""
    wh, ww = window
    out = []
    for si in range(n_scales):
        s = scale0 ** si
        sh, sw = int(h / s), int(w / s)
        if sh < wh + 2 or sw < ww + 2:
            break
        out.append((si, s, sh, sw))
    return out


def _group(raw: list, group_threshold: int, group_eps: float, max_detections: int):
    if not raw:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
    boxes, counts = group_rectangles(np.asarray(raw, np.float32), group_threshold, group_eps)
    order = np.argsort(-counts)[:max_detections]
    return boxes[order], counts[order]


def raw_hits(img, model: CascadeModel, scale0: float = 1.2, n_scales: int = 24,
             dense_stages: int = 3, capacity: int = 2048, device=None) -> list:
    """The raw hits of `detect_multi_scale` before grouping: (x, y, w, h)
    per accepted window, scale by scale, in window-index order."""
    img = on_device(img, device).to(torch.float32)
    h, w = img.shape
    wh, ww = model.window
    t = _stage_tensors(model, img.device)
    dense = _dense_tables(model, min(dense_stages, len(model.stage_thresholds)), img.device)
    levels, parts = _scales(h, w, model.window, scale0, n_scales), []
    for si, s, sh, sw in levels:
        scaled = imgproc.resize_bilinear(img, sh, sw) if si else img
        by, bx, alive = _detect_one_scale(scaled, t, dense, model, capacity)
        parts.append(torch.stack([by, bx, alive.to(by.dtype)]))
    if not parts:
        return []
    hits = torch.cat(parts, dim=1).cpu().numpy()  # one device read per image
    raw, at = [], 0
    for (si, s, sh, sw), p in zip(levels, parts):
        by, bx, alive = hits[:, at:at + p.shape[1]]
        at += p.shape[1]
        for y, x in zip(by[alive == 1], bx[alive == 1]):
            raw.append((x * s, y * s, ww * s, wh * s))
    return raw


def detect_multi_scale(
    img,
    model: CascadeModel,
    scale0: float = 1.2,
    n_scales: int = 24,  # loops until the window outgrows the image
    dense_stages: int = 3,
    capacity: int = 2048,
    max_detections: int = 64,
    group_threshold: int = 2,
    group_eps: float = 0.2,
    device=None,
):
    """detectMultiScale analog: the image pyramid slides the ORIGINAL
    window (cascadedetect.cpp scales the image, not the features); raw
    hits are merged with groupRectangles semantics. Returns numpy
    (boxes [K, 4] xywh f32, counts [K]), like the reference API. A
    tensor image stays on its device; numpy goes to the card unless
    `device="cpu"`."""
    raw = raw_hits(img, model, scale0, n_scales, dense_stages, capacity, device)
    return _group(raw, group_threshold, group_eps, max_detections)


def group_rectangles(rects: np.ndarray, group_threshold: int = 2,
                     eps: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """cv::groupRectangles (objdetect/src/cascadedetect.cpp:66): cluster
    by rectangle similarity, average each cluster, keep clusters with
    more than `group_threshold` members. rects: [N, 4] xywh (host)."""
    n = rects.shape[0]
    if n == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
    rects = np.asarray(rects, np.float32)
    # The JAX function runs a union-find over the similar pairs (i < j) in
    # row-major order: pair (i, j) hangs j's tree under i's root. Within
    # row i that root does not change, so the row's pairs merge every
    # component they touch into it at once. `root` holds each rect's
    # current root; the similarity is the scalar loop's f32 arithmetic,
    # a block of rows at a time.
    x, y, w, h = rects.T
    x2, y2 = x + w, y + h
    half_eps = np.float32(eps * 0.5)
    root = np.arange(n)
    merged = np.zeros(n, bool)
    for i0 in range(0, n, 256):
        i1 = min(i0 + 256, n)
        r, c = slice(i0, i1), slice(i0, n)
        delta = half_eps * (np.minimum(w[r, None], w[c]) + np.minimum(h[r, None], h[c]))
        sim = ((np.abs(x[r, None] - x[c]) <= delta) & (np.abs(y[r, None] - y[c]) <= delta)
               & (np.abs(x2[r, None] - x[c] - w[c]) <= delta)
               & (np.abs(y2[r, None] - y[c] - h[c]) <= delta))
        sim &= np.arange(i0, i1)[:, None] < np.arange(i0, n)[None, :]
        for i in np.nonzero(sim.any(axis=1))[0]:
            ri, others = root[i0 + i], root[i0 + np.nonzero(sim[i])[0]]
            others = others[others != ri]
            if others.size:
                merged[others] = True
                root[merged[root]] = ri
                merged[others] = False
    roots = root
    out_boxes, out_counts = [], []
    for r in np.unique(roots):
        members = rects[roots == r]
        if members.shape[0] > group_threshold:
            out_boxes.append(members.mean(0))
            out_counts.append(members.shape[0])
    if not out_boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
    return np.stack(out_boxes).astype(np.float32), np.asarray(out_counts, np.int32)


# ------------------------------------------------------------- LBP ---


class LBPCascadeModel(NamedTuple):
    """LBP cascade (cascadedetect.hpp LBPEvaluator +
    predictCategoricalStump). Each feature is ONE cell rect (x, y, w, h);
    the descriptor covers the 3x3 grid of such cells. Each stump carries
    a 256-bit subset (8 words; code bit set -> left leaf). No window
    normalization."""

    window: tuple[int, int]
    rects: np.ndarray        # [F, 4] i32 (x, y, w, h) of the top-left cell
    feature: np.ndarray      # [S] i32
    subsets: np.ndarray      # [S, 8] u32 words
    left: np.ndarray         # [S] f32
    right: np.ndarray        # [S] f32
    stage_offsets: np.ndarray
    stage_thresholds: np.ndarray


def load_opencv_lbp_cascade(path: str) -> LBPCascadeModel:
    """Parse an LBP cascade XML (featureType LBP)."""
    root = ET.parse(path).getroot()
    c = root.find("cascade")
    if c is None or (c.findtext("featureType") or "").strip() != "LBP":
        raise ValueError("not an LBP cascade")
    wh = (int(c.findtext("height")), int(c.findtext("width")))
    rects = [[int(v) for v in f.findtext("rect").split()][:4] for f in c.find("features")]
    feature, subsets, left, right = [], [], [], []
    offsets, thresholds = [0], []
    for stage in c.find("stages"):
        thresholds.append(float(stage.findtext("stageThreshold")))
        for wc in stage.find("weakClassifiers"):
            inter = [int(v) for v in wc.findtext("internalNodes").split()]
            # stump: [left-child=0, right-child=-1, featIdx, 8 subset words]
            if len(inter) != 11:
                raise ValueError("tree-based LBP cascade not supported")
            leaf = [float(v) for v in wc.findtext("leafValues").split()]
            feature.append(inter[2])
            subsets.append(inter[3:11])
            left.append(leaf[0])
            right.append(leaf[1])
        offsets.append(len(feature))
    return LBPCascadeModel(
        window=wh,
        rects=np.asarray(rects, np.int32),
        feature=np.asarray(feature, np.int32),
        subsets=np.asarray(subsets, np.int64).astype(np.uint32),
        left=np.asarray(left, np.float32),
        right=np.asarray(right, np.float32),
        stage_offsets=np.asarray(offsets, np.int32),
        stage_thresholds=np.asarray(thresholds, np.float32),
    )


# LBPEvaluator::calc's bit of each 3x3 cell (clockwise from top-left, mid-left last)
LBP_BITS = {(0, 0): 7, (0, 1): 6, (0, 2): 5, (1, 2): 4, (2, 2): 3, (2, 1): 2, (2, 0): 1, (1, 0): 0}
_LBP_GATHER_ELEMS = 1 << 27  # corner values per gather chunk (512 MB of f32)


def lbp_codes_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """8-bit LBP codes (int32) from grid corners [..., 4, 4, *rest]."""
    cells = (corners[..., 1:, 1:, :, :] - corners[..., :-1, 1:, :, :]
             - corners[..., 1:, :-1, :, :] + corners[..., :-1, :-1, :, :])
    center = cells[..., 1, 1, :, :]
    code = torch.zeros(center.shape, dtype=torch.int32, device=center.device)
    for (r, c), b in LBP_BITS.items():
        code = code | ((cells[..., r, c, :, :] >= center).to(torch.int32) << b)
    return code


def _lbp_feature_codes(ii: torch.Tensor, rects: np.ndarray, out_h: int, out_w: int) -> torch.Tensor:
    """[F, out_h, out_w] codes of every feature at every window origin:
    the 16 grid corners as one broadcast gather per chunk of features."""
    dev = ii.device
    r = torch.from_numpy(rects.astype(np.int64)).to(dev)
    steps = torch.arange(4, device=dev)
    gy = r[:, 1, None] + r[:, 3, None] * steps  # [F, 4]
    gx = r[:, 0, None] + r[:, 2, None] * steps
    yy = torch.arange(out_h, device=dev)[:, None]
    xx = torch.arange(out_w, device=dev)[None, :]
    chunk = max(1, _LBP_GATHER_ELEMS // (16 * out_h * out_w))
    codes = []
    for f0 in range(0, rects.shape[0], chunk):
        Y = gy[f0:f0 + chunk, :, None, None, None] + yy  # [f, 4, 1, oh, 1]
        X = gx[f0:f0 + chunk, None, :, None, None] + xx  # [f, 1, 4, 1, ow]
        codes.append(lbp_codes_from_corners(ii[Y, X]))
    return torch.cat(codes)


class _LBPTables(NamedTuple):
    feat_pad: torch.Tensor  # [T, Smax] i64 feature of each stage slot (F = none)
    slot_pad: torch.Tensor  # [T, Smax] i64 row of `lut` (S = the zero row)
    lut: torch.Tensor  # [(S + 1) * 256] f32 leaf value of each (stump, code)
    stage_thr: torch.Tensor  # [T]


def _lbp_tables(model: LBPCascadeModel, device) -> _LBPTables:
    S = len(model.feature)
    F = model.rects.shape[0]
    codes = np.arange(256)
    words = model.subsets.astype(np.int64)[:, codes >> 5]  # [S, 256]
    hit = (words >> (codes & 31)) & 1
    lut = np.zeros((S + 1, 256), np.float32)
    lut[:S] = np.where(hit == 1, model.left[:, None], model.right[:, None])
    offs = model.stage_offsets
    T, smax = len(model.stage_thresholds), int(np.diff(offs).max())
    feat_pad = np.full((T, smax), F, np.int64)
    slot_pad = np.full((T, smax), S, np.int64)
    for s in range(T):
        n = offs[s + 1] - offs[s]
        feat_pad[s, :n] = model.feature[offs[s]:offs[s + 1]]
        slot_pad[s, :n] = np.arange(offs[s], offs[s + 1])

    def t(a):
        return torch.from_numpy(a).to(device)

    return _LBPTables(t(feat_pad), t(slot_pad), t(lut.reshape(-1)),
                      t(np.asarray(model.stage_thresholds, np.float32)))


def _lbp_accept(img: torch.Tensor, model: LBPCascadeModel, tables: _LBPTables) -> torch.Tensor:
    wh, ww = model.window
    h, w = img.shape
    out_h, out_w = h - wh + 1, w - ww + 1
    ii = imgproc.integral(img.to(torch.float32))
    code = _lbp_feature_codes(ii, model.rects, out_h, out_w)
    code = torch.cat([code, code.new_zeros((1, out_h, out_w))]).to(torch.int64)  # row F: padding
    vals = tables.lut[tables.slot_pad[..., None, None] * 256 + code[tables.feat_pad]]  # [T, Smax, oh, ow]
    sums = torch.zeros((vals.shape[0], out_h, out_w), dtype=torch.float32, device=img.device)
    for k in range(vals.shape[1]):  # stump by stump, as XLA's in-order scatter-add
        sums = sums + vals[:, k]
    return (sums >= tables.stage_thr[:, None, None]).all(dim=0)


def lbp_score_map(img, model: LBPCascadeModel, device=None) -> torch.Tensor:
    """Every stage at the model's native scale: the acceptance mask
    [H - wh + 1, W - ww + 1] (the JAX `_lbp_scale_impl`)."""
    img = on_device(img, device).to(torch.float32)
    return _lbp_accept(img, model, _lbp_tables(model, img.device))


def raw_hits_lbp(img, model: LBPCascadeModel, scale0: float = 1.2, n_scales: int = 24,
                 device=None) -> list:
    """The raw hits of `detect_multi_scale_lbp` before grouping."""
    img = on_device(img, device).to(torch.float32)
    h, w = img.shape
    wh, ww = model.window
    tables = _lbp_tables(model, img.device)
    levels, maps = _scales(h, w, model.window, scale0, n_scales), []
    for si, s, sh, sw in levels:
        scaled = imgproc.resize_bilinear(img, sh, sw) if si else img
        maps.append(_lbp_accept(scaled, model, tables))
    if not maps:
        return []
    flat = torch.cat([m.reshape(-1) for m in maps]).cpu().numpy()  # one device read per image
    raw, at = [], 0
    for (si, s, sh, sw), m in zip(levels, maps):
        accept = flat[at:at + m.numel()].reshape(m.shape)
        at += m.numel()
        ys, xs = np.where(accept)
        for y, x in zip(ys, xs):
            raw.append((x * s, y * s, ww * s, wh * s))
    return raw


def detect_multi_scale_lbp(
    img,
    model: LBPCascadeModel,
    scale0: float = 1.2,
    n_scales: int = 24,
    max_detections: int = 64,
    group_threshold: int = 2,
    group_eps: float = 0.2,
    device=None,
):
    """detectMultiScale for LBP cascades: image pyramid, dense stage
    evaluation, groupRectangles (as the Haar detector)."""
    raw = raw_hits_lbp(img, model, scale0, n_scales, device)
    return _group(raw, group_threshold, group_eps, max_detections)
