"""Cascade training, the `apps/traincascade` analog (port of
opencv_tpu/ml/traincascade.py).

Reference: apps/traincascade/traincascade.cpp (CLI), cascadeclassifier.cpp
(stage loop: fill positives, mine hard negatives, train a boosted stage),
haarfeatures.cpp (the BASIC pool), lbpfeatures.cpp, boost.cpp (Gentle
AdaBoost stumps on variance-normalized feature values).

The JAX design is kept: the whole Haar pool is one sparse corner matrix
M [ii_size, F], so every feature of every sample is one product
ii_flat @ M; all features' stumps are fitted at once from per-feature
histograms of (w, w*y) over 64 quantization bins (256 LBP codes) and
their cumulative sums; Gentle AdaBoost updates w *= exp(-y f(x)). Host
Python drives the stage and negative-mining loop with the JAX
function's numpy random stream, so both packages mine the same crops.

Where the two packages part, and why:
- ii_flat @ M runs in f64 and is rounded once: every product is exact
  there and the sum of a feature's <= 9 corner terms too, so the value
  is the correctly rounded one whatever order the card's or the CPU's
  library takes. XLA's f32 product rounds in its own blocked order;
  both are exact, and equal, on integer-valued (8-bit) samples.
- The histograms add each sample's weight into its bin in sample order
  (one scatter of unique indices per sample): XLA's CPU scatter-add
  order, on either device (CUDA's scatter_add_ is atomic, in no order).
- exp runs in f64 and is rounded once (the same f32 on either device);
  XLA's f32 exp is not correctly rounded, so the weights of the second
  and later weak classifiers differ from JAX's in the last bit.
- Sums take `imgproc.xla_sum`, cumulative sums `imgproc._block_scan`,
  and the stump threshold lo + (b+1)/n_bins * span the fused
  multiply-add XLA makes of it under jit.
Matrix products run with TF32 off (`device.no_tf32`).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import no_tf32, on_device, resolve_device
from opencv_tpu_torch.ops.cascade import CascadeModel, LBPCascadeModel, lbp_codes_from_corners

# ------------------------------------------------------------- feature pool


def haar_feature_pool(window=(24, 24), pos_step=3, size_step=3, min_size=6) -> np.ndarray:
    """The BASIC Haar pool (haarfeatures.cpp): x2/y2 edges, x3/y3 lines,
    x2_y2 checkerboard, as up-to-3 weighted rects [F, 3, 5] of
    (x, y, w, h, weight) in the base window."""
    wh, ww = window
    feats = []

    def add(*rects):
        f = np.zeros((3, 5), np.float32)
        for i, r in enumerate(rects):
            f[i] = r
        feats.append(f)

    for fw in range(min_size, ww + 1, size_step):
        for fh in range(min_size, wh + 1, size_step):
            for x in range(0, ww - fw + 1, pos_step):
                for y in range(0, wh - fh + 1, pos_step):
                    if fw % 2 == 0:  # x2 edge: full(-1) + left half(+2)
                        add((x, y, fw, fh, -1.0), (x, y, fw // 2, fh, 2.0))
                    if fh % 2 == 0:  # y2 edge
                        add((x, y, fw, fh, -1.0), (x, y, fw, fh // 2, 2.0))
                    if fw % 3 == 0:  # x3 line: full(-1) + mid third(+3)
                        add((x, y, fw, fh, -1.0), (x + fw // 3, y, fw // 3, fh, 3.0))
                    if fh % 3 == 0:  # y3 line
                        add((x, y, fw, fh, -1.0), (x, y + fh // 3, fw, fh // 3, 3.0))
                    if fw % 2 == 0 and fh % 2 == 0:  # x2_y2 checkerboard
                        add((x, y, fw, fh, -1.0), (x, y, fw // 2, fh // 2, 2.0),
                            (x + fw // 2, y + fh // 2, fw // 2, fh // 2, 2.0))
    return np.stack(feats)


def _corner_matrix(rects: np.ndarray, window) -> np.ndarray:
    """Sparse corner matrix M [(wh+1)*(ww+1), F]: feature values for a
    sample batch are ii_flat @ M."""
    wh, ww = window
    iw = ww + 1
    M = np.zeros(((wh + 1) * iw, rects.shape[0]), np.float32)
    for f in range(rects.shape[0]):
        for r in range(3):
            x0, y0, rw, rh, wt = rects[f, r]
            if wt == 0.0:
                continue
            x0, y0, rw, rh = int(x0), int(y0), int(rw), int(rh)
            M[(y0 + rh) * iw + (x0 + rw), f] += wt
            M[y0 * iw + (x0 + rw), f] -= wt
            M[(y0 + rh) * iw + x0, f] -= wt
            M[y0 * iw + x0, f] += wt
    return M


def _sample_features(samples, M: torch.Tensor, window):
    """samples [N, wh, ww] -> (values [N, F] variance-normalized, inv_nf
    [N]) exactly as the evaluator normalizes windows. M is an f64 corner
    matrix on the device the work runs on."""
    wh, ww = window
    x = on_device(samples, M.device).to(torch.float32)
    ii = imgproc.integral(x)  # [N, wh+1, ww+1]
    ii2 = imgproc.integral(x * x)

    def rect_sum(a, y0, x0, h, w):
        return a[:, y0 + h, x0 + w] - a[:, y0, x0 + w] - a[:, y0 + h, x0] + a[:, y0, x0]

    narea = float((wh - 2) * (ww - 2))
    s1 = rect_sum(ii, 1, 1, wh - 2, ww - 2)
    s2 = rect_sum(ii2, 1, 1, wh - 2, ww - 2)
    nf2 = narea * s2 - s1 * s1
    nf = torch.sqrt(nf2.clamp_min(1e-12).double()).to(torch.float32)
    inv_nf = torch.where(nf2 > 0, torch.ones_like(nf) / nf, torch.ones_like(nf))
    with no_tf32():
        vals = (ii.reshape(ii.shape[0], -1).double() @ M).to(torch.float32)
    return vals * inv_nf[:, None], inv_nf


# ------------------------------------------------ vectorized GAB stumps


def _histograms(bins: torch.Tensor, n_bins: int, w: torch.Tensor, y: torch.Tensor) -> tuple:
    """Per-feature sums of w and w*y over the bins: bins [N, F] int. Each
    sample's F updates hit F distinct bins, so one scatter per sample, in
    sample order, adds exactly as XLA's in-order scatter-add."""
    n, f = bins.shape
    flat = torch.arange(f, device=bins.device)[None, :] * n_bins + bins.to(torch.int64)
    src = torch.stack([w, w * y], dim=1)  # [N, 2]
    hist = torch.zeros((f * n_bins, 2), dtype=torch.float32, device=bins.device)
    for i in range(n):
        hist.index_add_(0, flat[i], src[i].expand(f, 2))
    hist = hist.reshape(f, n_bins, 2)
    return hist[..., 0], hist[..., 1]


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp rounded once from f64: the same f32 on either device."""
    return torch.exp(x.double()).to(torch.float32)


def _fit_stumps_all(vals, y, w, n_bins: int = 64):
    """Gentle-AdaBoost stump fit for EVERY feature at once (the JAX
    function, jitted there). vals [N, F], y [N] in {-1, +1}, w [N].
    Returns per feature (err, thr, left, right); the stump predicts
    `left` where value < thr, else `right`."""
    f = vals.shape[1]
    lo = vals.amin(dim=0)
    hi = vals.amax(dim=0)
    span = (hi - lo).clamp_min(1e-12)
    q = ((vals - lo) / span * n_bins).to(torch.int32).clamp(0, n_bins - 1)
    wsum, wysum = _histograms(q, n_bins, w, y)
    cw = imgproc._block_scan(wsum)  # threshold candidates: boundaries 1..B-1
    cwy = imgproc._block_scan(wysum)
    lw, lwy = cw[:, :-1], cwy[:, :-1]
    rw, rwy = cw[:, -1:] - lw, cwy[:, -1:] - lwy
    left = lwy / lw.clamp_min(1e-12)
    right = rwy / rw.clamp_min(1e-12)
    gain = lwy * lwy / lw.clamp_min(1e-12) + rwy * rwy / rw.clamp_min(1e-12)
    gain = torch.where((lw > 1e-12) & (rw > 1e-12), gain, torch.full_like(gain, -float("inf")))
    b = torch.argmax(gain, dim=1)
    ar = torch.arange(f, device=vals.device)
    err = imgproc.xla_sum(w) - gain[ar, b]
    frac = (b + 1).to(torch.float32) / n_bins
    thr = (frac.double() * span.double() + lo.double()).to(torch.float32)  # XLA's fused multiply-add
    return err, thr, left[ar, b], right[ar, b]


# --------------------------------------------------------- stage training


class _Stump(NamedTuple):
    feature: int
    threshold: float
    left: float
    right: float


def _initial(n_pos: int, n_neg: int, device):
    y = torch.cat([torch.ones(n_pos), -torch.ones(n_neg)]).to(device)
    w = torch.cat([torch.full((n_pos,), 0.5 / n_pos), torch.full((n_neg,), 0.5 / n_neg)]).to(device)
    return y, w


def _stage_threshold(scores: torch.Tensor, n_pos: int, min_hit_rate: float):
    """(threshold 1e-6 below the minHitRate percentile of the positives'
    scores, false-alarm rate of the negatives at its f32 value)."""
    s = scores.cpu().numpy()
    ps = np.sort(s[:n_pos])
    sthr = float(ps[int(np.floor((1.0 - min_hit_rate) * n_pos))]) - 1e-6
    return sthr, float(np.mean(s[n_pos:] >= np.float32(sthr)))


def _train_stage(pos_vals, neg_vals, min_hit_rate, max_false_alarm, max_weak):
    """One boosted stage (CascadeBoost::train analog). Returns (stumps,
    stage_threshold, pos_scores, neg_scores)."""
    vals = torch.cat([pos_vals, neg_vals])
    n_pos = pos_vals.shape[0]
    y, w = _initial(n_pos, neg_vals.shape[0], vals.device)
    scores = torch.zeros(vals.shape[0], dtype=torch.float32, device=vals.device)
    stumps = []
    for _ in range(max_weak):
        err, thr, left, right = _fit_stumps_all(vals, y, w)
        fbest = int(torch.argmin(err))
        t, lv, rv = float(thr[fbest]), float(left[fbest]), float(right[fbest])
        stumps.append(_Stump(fbest, t, lv, rv))
        pred = torch.where(vals[:, fbest] < t, lv, rv)
        scores = scores + pred
        w = w * _exp(-y * pred)
        w = w / imgproc.xla_sum(w)
        sthr, fa = _stage_threshold(scores, n_pos, min_hit_rate)
        if fa <= max_false_alarm:
            break
    s = scores.cpu().numpy()
    return stumps, sthr, s[:n_pos], s[n_pos:]


def _random_crops(rng, negative_images, n: int, window) -> np.ndarray:
    """n random window crops of the negative images (the reference's
    NegReader walk), drawn from `rng` as the JAX function draws them."""
    wh, ww = window
    out = np.empty((n, wh, ww), np.float32)
    for i in range(n):
        img = negative_images[rng.integers(len(negative_images))]
        y = rng.integers(0, img.shape[0] - wh + 1)
        x = rng.integers(0, img.shape[1] - ww + 1)
        out[i] = img[y:y + wh, x:x + ww]
    return out


def _stage_sums_pass(cols, stages, sthrs) -> torch.Tensor:
    """Crops that pass every stage: cols(k) gives the [N] feature values
    (or codes) of stump k's feature; stage sums add stump by stump in f32
    and are held against the f32 stage thresholds."""
    ok, k = None, 0
    for st, sthr in zip(stages, sthrs):
        ssum = None
        for stump in st:
            v = cols(k, stump)
            ssum = v if ssum is None else ssum + v
            k += 1
        stage_ok = ssum >= float(np.float32(sthr))
        ok = stage_ok if ok is None else ok & stage_ok
    return ok


# ------------------------------------------------------------ cascade loop


def train_cascade(
    positives,
    negative_images: list,
    window=(24, 24),
    n_stages: int = 8,
    min_hit_rate: float = 0.995,
    max_false_alarm: float = 0.5,
    max_weak_per_stage: int = 25,
    n_neg_per_stage: int = 1000,
    pos_step: int = 3,
    size_step: int = 3,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> CascadeModel:
    """Train a Haar cascade (traincascade.cpp flow): per stage, mine
    negatives that PASS all previous stages from random crops of
    `negative_images`, boost a stage to minHitRate / maxFalseAlarm,
    repeat. positives: [P, wh, ww] aligned object crops. The work runs
    on the card unless `device="cpu"`; the model comes back as numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rects = haar_feature_pool(window, pos_step, size_step)
    M_np = _corner_matrix(rects, window)
    M = torch.from_numpy(M_np).to(dev, torch.float64)
    pos_vals, _ = _sample_features(positives, M, window)

    def model_from(stages, sthrs, used_feats):
        remap = {f: i for i, f in enumerate(used_feats)}
        feat, thr, lv, rv, offs = [], [], [], [], [0]
        for st in stages:
            for s in st:
                feat.append(remap[s.feature])
                thr.append(s.threshold)
                lv.append(s.left)
                rv.append(s.right)
            offs.append(len(feat))
        return CascadeModel(
            window=window,
            rects=rects[np.asarray(used_feats, np.int64)] if used_feats else rects[:1],
            feature=np.asarray(feat, np.int32),
            threshold=np.asarray(thr, np.float32),
            left=np.asarray(lv, np.float32),
            right=np.asarray(rv, np.float32),
            stage_offsets=np.asarray(offs, np.int32),
            stage_thresholds=np.asarray(sthrs, np.float32),
        )

    def passes(stages, sthrs, crops) -> np.ndarray:
        """Crops accepted by the stages so far (the evaluator's
        normalization), from the values of the stumps' features only."""
        feats = [s.feature for st in stages for s in st]
        vals, _ = _sample_features(crops, M[:, feats], window)
        return _stage_sums_pass(
            lambda k, s: torch.where(vals[:, k] < float(np.float32(s.threshold)),
                                     float(np.float32(s.left)), float(np.float32(s.right))),
            stages, sthrs).cpu().numpy()

    stages, sthrs = [], []
    neg = _random_crops(rng, negative_images, n_neg_per_stage, window)
    for si in range(n_stages):
        neg_vals, _ = _sample_features(neg, M, window)
        stumps, sthr, ps, ns = _train_stage(pos_vals, neg_vals, min_hit_rate, max_false_alarm,
                                            max_weak_per_stage)
        stages.append(stumps)
        sthrs.append(sthr)
        if verbose:
            print(f"stage {si}: {len(stumps)} stumps, hit={float(np.mean(ps >= sthr)):.4f} "
                  f"fa={float(np.mean(ns >= sthr)):.4f}")
        if si == n_stages - 1:
            break
        # mine hard negatives: random crops that pass every stage so far
        mined = []
        for _ in range(60):
            cand = _random_crops(rng, negative_images, 4 * n_neg_per_stage, window)
            mined.append(cand[passes(stages, sthrs, cand)])
            if sum(m.shape[0] for m in mined) >= n_neg_per_stage:
                break
        # mining came up dry: stop rather than train on easy negatives
        neg = np.concatenate(mined)[:n_neg_per_stage]
        if neg.shape[0] < max(32, n_neg_per_stage // 20):
            if verbose:
                print(f"stage {si}: negatives exhausted ({neg.shape[0]} left) — stopping early")
            break
    return model_from(stages, sthrs, sorted({s.feature for st in stages for s in st}))


# ----------------------------------------------------------- LBP variant


def lbp_feature_pool(window=(24, 24), pos_step=2, size_step=1) -> np.ndarray:
    """LBP cell-rect pool (lbpfeatures.cpp): every (x, y, cw, ch) whose
    3x3 cell grid fits the window. [F, 4] i32."""
    wh, ww = window
    out = []
    for cw in range(1, ww // 3 + 1, size_step):
        for ch in range(1, wh // 3 + 1, size_step):
            for x in range(0, ww - 3 * cw + 1, pos_step):
                for y in range(0, wh - 3 * ch + 1, pos_step):
                    out.append((x, y, cw, ch))
    return np.asarray(out, np.int32)


def _lbp_codes(samples, rects: np.ndarray, device) -> torch.Tensor:
    """[N, F] int32 8-bit LBP codes in LBPEvaluator::calc's bit order."""
    x = on_device(samples, device).to(torch.float32)
    ii = imgproc.integral(x)  # [N, wh+1, ww+1]
    r = torch.from_numpy(rects.astype(np.int64)).to(x.device)
    steps = torch.arange(4, device=x.device)
    gy = r[:, 1, None] + r[:, 3, None] * steps  # [F, 4]
    gx = r[:, 0, None] + r[:, 2, None] * steps
    corners = ii[:, gy[:, :, None], gx[:, None, :]]  # [N, F, 4, 4]
    return lbp_codes_from_corners(corners.permute(2, 3, 0, 1))


def _fit_lbp_stumps_all(codes, y, w):
    """Categorical GAB stump for every LBP feature at once (the JAX
    function, jitted there): per feature the per-code weighted means, the
    codes sorted by them (stable), the best split of that order in
    closed form (Breiman). codes [N, F] int 0..255. Returns (err, subset
    [F, 256] bool = codes of the LEFT leaf, left, right)."""
    f = codes.shape[1]
    wsum, wysum = _histograms(codes, 256, w, y)
    mean = wysum / wsum.clamp_min(1e-12)
    mean = torch.where(wsum > 0, mean, torch.zeros_like(mean))  # empty codes: neutral
    order = torch.argsort(mean, dim=1, stable=True)
    sw = torch.gather(wsum, 1, order)
    swy = torch.gather(wysum, 1, order)
    cw_ = imgproc._block_scan(sw)[:, :-1]  # weight left of split k
    cwy = imgproc._block_scan(swy)[:, :-1]
    rw = imgproc.xla_sum(sw)[:, None] - cw_
    rwy = imgproc.xla_sum(swy)[:, None] - cwy
    gain = cwy * cwy / cw_.clamp_min(1e-12) + rwy * rwy / rw.clamp_min(1e-12)
    gain = torch.where((cw_ > 1e-12) & (rw > 1e-12), gain, torch.full_like(gain, -float("inf")))
    k = torch.argmax(gain, dim=1)
    ar = torch.arange(f, device=codes.device)
    err = imgproc.xla_sum(w) - gain[ar, k]
    left = cwy[ar, k] / cw_[ar, k].clamp_min(1e-12)
    right = rwy[ar, k] / rw[ar, k].clamp_min(1e-12)
    rank = torch.argsort(order, dim=1)  # rank of each code in the sort
    return err, rank <= k[:, None], left, right


def _subset_words(mask256: np.ndarray) -> np.ndarray:
    """[256] bool -> [8] u32 words (evaluator layout: word = code >> 5,
    bit = code & 31)."""
    w = np.zeros(8, np.uint32)
    for code in np.nonzero(mask256)[0]:
        w[code >> 5] |= np.uint32(1) << np.uint32(code & 31)
    return w


def train_cascade_lbp(
    positives,
    negative_images: list,
    window=(24, 24),
    n_stages: int = 8,
    min_hit_rate: float = 0.995,
    max_false_alarm: float = 0.5,
    max_weak_per_stage: int = 20,
    n_neg_per_stage: int = 1000,
    pos_step: int = 2,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> LBPCascadeModel:
    """traincascade -featureType LBP analog: an LBPCascadeModel
    (subset-stump cascade, no window normalization). The work runs on the
    card unless `device="cpu"`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rects = lbp_feature_pool(window, pos_step)
    pos_codes = _lbp_codes(positives, rects, dev)
    stages, sthrs = [], []

    def passes(crops) -> np.ndarray:
        used = sorted({fidx for st in stages for (fidx, _, _, _) in st})
        col = {f: i for i, f in enumerate(used)}
        codes = _lbp_codes(crops, rects[np.asarray(used, np.int64)], dev).to(torch.int64)
        luts = [torch.from_numpy(np.where(sub, np.float32(lv), np.float32(rv)).astype(np.float32)).to(dev)
                for st in stages for (_, sub, lv, rv) in st]
        feats = [fidx for st in stages for (fidx, _, _, _) in st]
        return _stage_sums_pass(lambda k, s: luts[k][codes[:, col[feats[k]]]],
                                stages, sthrs).cpu().numpy()

    neg = _random_crops(rng, negative_images, n_neg_per_stage, window)
    for si in range(n_stages):
        codes = torch.cat([pos_codes, _lbp_codes(neg, rects, dev)])
        n_pos = pos_codes.shape[0]
        y, w = _initial(n_pos, codes.shape[0] - n_pos, dev)
        codes64 = codes.to(torch.int64)
        scores = torch.zeros(codes.shape[0], dtype=torch.float32, device=dev)
        st = []
        for _ in range(max_weak_per_stage):
            err, subset, left, right = _fit_lbp_stumps_all(codes, y, w)
            fb = int(torch.argmin(err))
            lv, rv = float(left[fb]), float(right[fb])
            st.append((fb, subset[fb].cpu().numpy(), lv, rv))
            pred = torch.where(subset[fb][codes64[:, fb]], lv, rv)
            scores = scores + pred
            w = w * _exp(-y * pred)
            w = w / imgproc.xla_sum(w)
            sthr, fa = _stage_threshold(scores, n_pos, min_hit_rate)
            if fa <= max_false_alarm:
                break
        stages.append(st)
        sthrs.append(sthr)
        if verbose:
            print(f"stage {si}: {len(st)} stumps, fa={fa:.3f}")
        if si == n_stages - 1:
            break
        mined = []
        for _ in range(60):
            cand = _random_crops(rng, negative_images, 4 * n_neg_per_stage, window)
            mined.append(cand[passes(cand)])
            if sum(m.shape[0] for m in mined) >= n_neg_per_stage:
                break
        got = np.concatenate(mined)
        if got.shape[0] < max(32, n_neg_per_stage // 20):
            if verbose:
                print(f"stage {si}: negatives exhausted — stopping")
            break
        neg = got[:n_neg_per_stage]

    feature, subsets, left, right, offs = [], [], [], [], [0]
    used = sorted({f for st in stages for (f, _, _, _) in st})
    remap = {f: i for i, f in enumerate(used)}
    for st in stages:
        for (f, sub, lv, rv) in st:
            feature.append(remap[f])
            subsets.append(_subset_words(sub))
            left.append(lv)
            right.append(rv)
        offs.append(len(feature))
    return LBPCascadeModel(
        window=window,
        rects=rects[np.asarray(used, np.int64)],
        feature=np.asarray(feature, np.int32),
        subsets=np.stack(subsets).astype(np.uint32),
        left=np.asarray(left, np.float32),
        right=np.asarray(right, np.float32),
        stage_offsets=np.asarray(offs, np.int32),
        stage_thresholds=np.asarray(sthrs, np.float32),
    )


# ------------------------------------------------------------ XML export


def _cascade_root(model, feature_type: str, max_cat_count: str):
    wh, ww = model.window
    root = ET.Element("opencv_storage")
    casc = ET.SubElement(root, "cascade")
    casc.set("type_id", "opencv-cascade-classifier")
    ET.SubElement(casc, "stageType").text = "BOOST"
    ET.SubElement(casc, "featureType").text = feature_type
    ET.SubElement(casc, "height").text = str(wh)
    ET.SubElement(casc, "width").text = str(ww)
    counts = np.diff(model.stage_offsets)
    ET.SubElement(ET.SubElement(casc, "stageParams"), "maxWeakCount").text = str(int(counts.max()))
    ET.SubElement(ET.SubElement(casc, "featureParams"), "maxCatCount").text = max_cat_count
    ET.SubElement(casc, "stageNum").text = str(len(model.stage_thresholds))
    return root, casc, counts


def _stages_xml(casc, model, counts, internal_nodes):
    stages = ET.SubElement(casc, "stages")
    for s, sthr in enumerate(model.stage_thresholds):
        st = ET.SubElement(stages, "_")
        ET.SubElement(st, "maxWeakCount").text = str(int(counts[s]))
        ET.SubElement(st, "stageThreshold").text = f"{float(sthr):.10e}"
        wcs = ET.SubElement(st, "weakClassifiers")
        for k in range(model.stage_offsets[s], model.stage_offsets[s + 1]):
            wc = ET.SubElement(wcs, "_")
            ET.SubElement(wc, "internalNodes").text = internal_nodes(k)
            ET.SubElement(wc, "leafValues").text = (
                f"{float(model.left[k]):.10e} {float(model.right[k]):.10e}")


def _write_xml(root, path: str):
    tree = ET.ElementTree(root)
    ET.indent(tree)
    with open(path, "wb") as fh:
        fh.write(b"<?xml version=\"1.0\"?>\n")
        tree.write(fh)


def save_opencv_cascade(model: CascadeModel, path: str):
    """Write a Haar CascadeModel as the OpenCV cascade XML (the artifact
    traincascade emits for CascadeClassifier::load), byte for byte the
    JAX writer's; `ops.cascade.load_opencv_cascade` reads it back."""
    root, casc, counts = _cascade_root(model, "HAAR", "0")
    _stages_xml(casc, model, counts, lambda k: (
        f"0 -1 {int(model.feature[k])} {float(model.threshold[k]):.10e}"))
    feats = ET.SubElement(casc, "features")
    for f in range(model.rects.shape[0]):
        fe = ET.SubElement(feats, "_")
        rects = ET.SubElement(fe, "rects")
        for r in range(3):
            x, y, rw, rh, wt = model.rects[f, r]
            if wt == 0.0:
                continue
            ET.SubElement(rects, "_").text = f"{int(x)} {int(y)} {int(rw)} {int(rh)} {float(wt):.1f}"
        ET.SubElement(fe, "tilted").text = "0"
    _write_xml(root, path)


def save_opencv_lbp_cascade(model: LBPCascadeModel, path: str):
    """Write an LBPCascadeModel as the OpenCV LBP cascade XML (featureType
    LBP; internalNodes = [0, -1, featIdx, 8 subset words as signed
    int32]); `ops.cascade.load_opencv_lbp_cascade` reads it back."""
    root, casc, counts = _cascade_root(model, "LBP", "256")

    def nodes(k):
        words = " ".join(str(int(np.int32(np.uint32(v)))) for v in model.subsets[k])
        return f"0 -1 {int(model.feature[k])} {words}"

    _stages_xml(casc, model, counts, nodes)
    feats = ET.SubElement(casc, "features")
    for f in range(model.rects.shape[0]):
        x, y, rw, rh = (int(v) for v in model.rects[f])
        ET.SubElement(ET.SubElement(feats, "_"), "rect").text = f"{x} {y} {rw} {rh}"
    _write_xml(root, path)
