"""DNN layers (port of opencv_tpu/dnn/layers.py; reference: the layer zoo
of modules/dnn/src/layers/*). Data layout NCHW like the reference.

Each layer is the PyTorch operation of the JAX function's XLA operation:
convolutions are `F.conv2d` with XLA's padding rules written out
(explicit pairs, or "SAME"/"VALID" strings at any stride), pooling is
VALID like `lax.reduce_window`'s here, matrix products are `@`. The
layers that multiply (convolution, fully connected, LSTM, GRU) run inside
`device.no_tf32()` whatever the caller's switches: torch's default
`cudnn.allow_tf32` would round the card's convolution inputs to TF32,
and the JAX reference computes in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.device import no_tf32, resolve_device


def same_pads(size: int, k: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: output ceil(size /
    stride); the odd pixel of the padding goes on the high side."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv_pads(pad, size_hw, k_hw, stride_hw):
    """[(top, bottom), (left, right)] of a "SAME"/"VALID" string or of
    explicit pairs."""
    if isinstance(pad, str):
        if pad.upper() == "VALID":
            return [(0, 0), (0, 0)]
        return [same_pads(s, k, st) for s, k, st in zip(size_hw, k_hw, stride_hw)]
    return [tuple(int(v) for v in p) for p in pad]


def pad_hw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad (or, for negative entries, crop) the last two dims by
    [(top, bottom), (left, right)]."""
    (t, b), (l, r) = pads
    if t or b or l or r:
        return F.pad(x, (l, r, t, b), value=value)
    return x


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(s) for s in v)


@no_tf32()
def convolution(x, weights, bias=None, stride=1, pad="SAME", groups=1):
    """x [N, C, H, W], weights [O, C/groups, kh, kw]; pad "SAME", "VALID"
    or [(top, bottom), (left, right)] (XLA's conventions)."""
    s = _pair(stride)
    pads = conv_pads(pad, x.shape[2:], weights.shape[2:], s)
    out = F.conv2d(pad_hw(x, pads), weights, None, stride=s, groups=groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@no_tf32()
def fully_connected(x, weights, bias=None):
    """x [N, D] (flattened on entry), weights [O, D]."""
    out = x.reshape(x.shape[0], -1) @ weights.T
    if bias is not None:
        out = out + bias
    return out


def relu(x):
    return torch.clamp_min(x, 0.0)


def sigmoid(x):
    return torch.sigmoid(x)


def softmax(x, axis=1):
    return torch.softmax(x, dim=axis)


def max_pool(x, ksize=2, stride=None):
    """VALID max pooling (so a 2x2 stride-1 pool shrinks the map by one,
    as the JAX layer does; darknet itself pads there)."""
    return F.max_pool2d(x, ksize, stride or ksize)


def avg_pool(x, ksize=2, stride=None):
    stride = stride or ksize
    s = F.avg_pool2d(x, ksize, stride, divisor_override=1)
    return s / (ksize * ksize)


def batch_norm(x, mean, var, gamma, beta, eps=1e-5):
    shape = (1, -1, 1, 1) if x.ndim == 4 else (1, -1)
    return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            ) * gamma.reshape(shape) + beta.reshape(shape)


def concat(xs, axis=1):
    return torch.cat(list(xs), dim=axis)


def flatten(x):
    return x.reshape(x.shape[0], -1)


# --------------------------------------------------------------------------
# Detection heads (reference: dnn/src/layers/region_layer.cpp,
# detection_output_layer.cpp, prior_box_layer.cpp)
# --------------------------------------------------------------------------


def region_decode(x: torch.Tensor, anchors: torch.Tensor, classes: int, use_softmax: bool = True,
                  thresh: float = 0.2, wh_norm: tuple[float, float] | None = None) -> torch.Tensor:
    """YOLO v2 [region] / v3 [yolo] head (region_layer.cpp:234-292).

    x: conv output [N, A*(5+classes), H, W] (darknet layout). anchors:
    [A, 2] (w, h). wh_norm: divisor of exp(wh)*anchor — (cols, rows) for
    v2 (anchors in grid units, the default), (netw, neth) for v3.
    Returns [N, H*W*A, 5+classes]: (cx, cy, w, h, objectness, probs...)
    in image-normalized coords; class probs are objectness * p(class),
    zeroed at or below `thresh`; row index (y*cols + x)*anchors + a."""
    n, c, h, w = x.shape
    a = anchors.shape[0]
    cell = 5 + classes
    assert c == a * cell, (c, a, cell)
    wn, hn = wh_norm if wh_norm is not None else (float(w), float(h))
    t = x.reshape(n, a, cell, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[None, None, :, None]
    bx = (gx + torch.sigmoid(t[:, :, 0])) / w
    by = (gy + torch.sigmoid(t[:, :, 1])) / h
    bw = torch.exp(t[:, :, 2]) * anchors[None, :, 0, None, None] / wn
    bh = torch.exp(t[:, :, 3]) * anchors[None, :, 1, None, None] / hn
    obj = torch.sigmoid(t[:, :, 4])
    probs = t[:, :, 5:]
    p = torch.softmax(probs, dim=2) if use_softmax else torch.sigmoid(probs)
    conf = obj[:, :, None] * p
    conf = torch.where(conf > thresh, conf, torch.zeros_like(conf))
    out = torch.cat([bx[:, :, None], by[:, :, None], bw[:, :, None], bh[:, :, None],
                     obj[:, :, None], conf], dim=2)  # [N, A, cell, H, W]
    return out.permute(0, 3, 4, 1, 2).reshape(n, h * w * a, cell)


def nms_boxes(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.4,
              score_threshold: float = 0.0, max_out: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy IoU NMS (cv::dnn::NMSBoxes, nms.cpp; do_nms_sort in
    region_layer.cpp:301). boxes [M, 4] as (cx, cy, w, h). A fixed
    `max_out` rounds of select-max + suppress on the device (no host
    read), as the JAX fori_loop. Returns (idx [max_out] i32, -1 where
    unused, keep [max_out] bool)."""
    x1 = boxes[:, 0] - boxes[:, 2] / 2
    y1 = boxes[:, 1] - boxes[:, 3] / 2
    x2 = boxes[:, 0] + boxes[:, 2] / 2
    y2 = boxes[:, 1] + boxes[:, 3] / 2
    area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    cols = torch.stack([x1, y1, x2, y2, area, scores])  # [6, M]
    ar = torch.arange(boxes.shape[0], device=boxes.device)
    live = scores > score_threshold
    neg_inf = torch.full_like(scores, -float("inf"))
    idx = torch.full((max_out,), -1, dtype=torch.int32, device=boxes.device)
    keep = torch.zeros((max_out,), dtype=torch.bool, device=boxes.device)
    for k in range(max_out):  # gathers, not indexing by a 0-d tensor: no host read
        i = torch.argmax(torch.where(live, scores, neg_inf)).reshape(1)
        bx1, by1, bx2, by2, barea, bscore = cols.index_select(1, i)
        ok = live.index_select(0, i) & (bscore > score_threshold)
        idx[k:k + 1] = torch.where(ok, i.to(torch.int32), -1)
        keep[k:k + 1] = ok
        inter = (torch.clamp_min(torch.minimum(x2, bx2) - torch.maximum(x1, bx1), 0)
                 * torch.clamp_min(torch.minimum(y2, by2) - torch.maximum(y1, by1), 0))
        iou = inter / torch.clamp_min(area + barea - inter, 1e-9)
        live = live & ~((iou > iou_threshold) & ok) & (ar != i)
    return idx, keep


def prior_box(feat_h: int, feat_w: int, img_h: int, img_w: int, min_size: float,
              max_size: float | None = None, aspect_ratios: tuple[float, ...] = (2.0,),
              flip: bool = True, clip: bool = False,
              variances: tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2),
              device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD PriorBox (prior_box_layer.cpp): anchor grid of one feature map.
    Returns (priors [K, 4] as normalized (x1, y1, x2, y2), variances
    [K, 4]), K = feat_h * feat_w * boxes per cell (host arithmetic in
    f64, as the JAX function's)."""
    sizes = [(min_size, min_size)]
    if max_size is not None:
        sizes.append(((min_size * max_size) ** 0.5,) * 2)
    ars = list(aspect_ratios) + ([1.0 / a for a in aspect_ratios] if flip else [])
    for ar in ars:
        sizes.append((min_size * ar ** 0.5, min_size / ar ** 0.5))
    step_x, step_y = img_w / feat_w, img_h / feat_h
    out = []
    for y in range(feat_h):
        for x in range(feat_w):
            cx, cy = (x + 0.5) * step_x, (y + 0.5) * step_y
            for bw, bh in sizes:
                out.append([(cx - bw / 2) / img_w, (cy - bh / 2) / img_h,
                            (cx + bw / 2) / img_w, (cy + bh / 2) / img_h])
    pri = torch.as_tensor(np.asarray(out, np.float32), device=resolve_device(device))
    if clip:
        pri = pri.clamp(0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32, device=pri.device).repeat(pri.shape[0], 1)
    return pri, var


def detection_output(loc: torch.Tensor, conf: torch.Tensor, priors: torch.Tensor,
                     variances: torch.Tensor, num_classes: int, background_id: int = 0,
                     conf_threshold: float = 0.01, nms_threshold: float = 0.45,
                     top_k: int = 100) -> torch.Tensor:
    """SSD DetectionOutput (detection_output_layer.cpp): decode
    CENTER_SIZE loc deltas against priors, per-class NMS, the reference's
    [k, 7] rows (img_id, label, conf, x1, y1, x2, y2) padded with -1 ids.
    loc [N, K*4], conf [N, K*num_classes], priors/variances [K, 4]."""
    n, k = loc.shape[0], priors.shape[0]
    loc = loc.reshape(n, k, 4)
    conf = conf.reshape(n, k, num_classes)
    pcx = (priors[:, 0] + priors[:, 2]) / 2
    pcy = (priors[:, 1] + priors[:, 3]) / 2
    pw = priors[:, 2] - priors[:, 0]
    ph = priors[:, 3] - priors[:, 1]
    cx = variances[:, 0] * loc[..., 0] * pw + pcx
    cy = variances[:, 1] * loc[..., 1] * ph + pcy
    bw = torch.exp(variances[:, 2] * loc[..., 2]) * pw
    bh = torch.exp(variances[:, 3] * loc[..., 3]) * ph
    boxes = torch.stack([cx, cy, bw, bh], dim=-1)  # [N, K, 4] cxcywh
    rows = []
    for b in range(n):
        for cls in range(num_classes):
            if cls == background_id:
                continue
            idx, keep = nms_boxes(boxes[b], conf[b, :, cls], iou_threshold=nms_threshold,
                                  score_threshold=conf_threshold, max_out=top_k)
            sel = torch.clamp_min(idx, 0).to(torch.int64)
            bb = boxes[b][sel]
            minus = torch.full_like(bb[:, 0], -1.0)
            rows.append(torch.stack([
                torch.where(keep, torch.full_like(minus, float(b)), minus),
                torch.where(keep, torch.full_like(minus, float(cls)), minus),
                torch.where(keep, conf[b, :, cls][sel], torch.zeros_like(minus)),
                bb[:, 0] - bb[:, 2] / 2, bb[:, 1] - bb[:, 3] / 2,
                bb[:, 0] + bb[:, 2] / 2, bb[:, 1] + bb[:, 3] / 2,
            ], dim=-1))
    return torch.cat(rows, dim=0)


@no_tf32()
def lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias=None, h0=None, c0=None):
    """LSTM over a sequence (recurrent_layers.cpp LSTMLayer). x [T, N, D];
    w_ih [4H, D], w_hh [4H, H], bias [4H], gate order (i, f, o, g) (the
    reference's, not torch's i, f, g, o). Returns (outputs [T, N, H],
    (h_T, c_T)); a Python loop over time."""
    n = x.shape[1]
    hdim = w_hh.shape[1]
    h = torch.zeros((n, hdim), dtype=x.dtype, device=x.device) if h0 is None else h0
    c = torch.zeros((n, hdim), dtype=x.dtype, device=x.device) if c0 is None else c0
    ys = []
    for xt in x:
        z = xt @ w_ih.T + h @ w_hh.T
        if bias is not None:
            z = z + bias
        i, f, o, g = torch.split(z, hdim, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), (h, c)


@no_tf32()
def gru(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias_ih=None, bias_hh=None,
        h0=None, linear_before_reset: bool = True):
    """GRU over a sequence (ONNX GRU semantics). x [T, N, D]; w_ih [3H, D],
    w_hh [3H, H] in ONNX gate order (z, r, h); separate input and
    recurrence biases [3H] (with linear_before_reset the recurrence bias
    sits inside the reset-gate product). Returns (outputs [T, N, H],
    h_T)."""
    n = x.shape[1]
    hdim = w_hh.shape[1]
    h = torch.zeros((n, hdim), dtype=x.dtype, device=x.device) if h0 is None else h0
    zeros = torch.zeros((3 * hdim,), dtype=x.dtype, device=x.device)
    bi_z, bi_r, bi_h = torch.split(zeros if bias_ih is None else bias_ih, hdim)
    bh_z, bh_r, bh_h = torch.split(zeros if bias_hh is None else bias_hh, hdim)
    w_z, w_r, w_h = torch.split(w_ih, hdim, dim=0)
    r_z, r_r, r_h = torch.split(w_hh, hdim, dim=0)
    ys = []
    for xt in x:
        z = torch.sigmoid(xt @ w_z.T + h @ r_z.T + bi_z + bh_z)
        r = torch.sigmoid(xt @ w_r.T + h @ r_r.T + bi_r + bh_r)
        if linear_before_reset:
            hh = torch.tanh(xt @ w_h.T + bi_h + r * (h @ r_h.T + bh_h))
        else:
            hh = torch.tanh(xt @ w_h.T + bi_h + (r * h) @ r_h.T + bh_h)
        h = (1.0 - z) * hh + z * h
        ys.append(h)
    return torch.stack(ys), h
