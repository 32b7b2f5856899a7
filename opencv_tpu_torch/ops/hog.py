"""HOG descriptor and sliding-window linear-SVM detector (port of
opencv_tpu/ops/hog.py).

Reference: the CPU `HOGDescriptor` (objdetect/src/hog.cpp) and the GPU
pipeline the fork's TBD app drives (cudaobjdetect/src/cuda/hog.cu;
detectMultiScale in cudaobjdetect/src/hog.cpp).

The JAX design is kept: a dense per-pixel vote map [H, W, bins]; each
block histogram (Gaussian window times the bilinear cell weights, both
separable) as two strided separable correlations of the vote map; the
reference's two-step L2-Hys; and the per-window SVM dot product as one
correlation of the block-feature map with the weight tensor per scale.
XLA computed those correlations outside any Pallas kernel, and here they
are `torch.nn.functional.conv2d` (a correlation with the same strides as
`lax.conv_general_dilated`). They run with TF32 off: cuDNN's default
would round the block features to 10 mantissa bits.

Default geometry is the reference's pedestrian detector: 64x128 window,
8x8 cells, 2x2-cell blocks, 8-pixel block stride, 9 unsigned bins.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.device import no_tf32, resolve_device

_DIFF = np.array([-1.0, 0.0, 1.0], np.float32)
_ONE = np.array([1.0], np.float32)


@dataclasses.dataclass(frozen=True)
class HOGConfig:
    win_h: int = 128
    win_w: int = 64
    cell: int = 8
    block_cells: int = 2  # 2x2 cells per block
    n_bins: int = 9
    l2hys_clip: float = 0.2
    gamma: bool = True  # sqrt gamma correction (reference default)

    @property
    def block_px(self):
        return self.cell * self.block_cells

    @property
    def win_sigma(self):
        # getWinSigma (hog.cpp:101): (blockSize.w + blockSize.h) / 8
        return 2.0 * self.block_px / 8.0

    @property
    def cells_y(self):
        return self.win_h // self.cell

    @property
    def cells_x(self):
        return self.win_w // self.cell

    @property
    def blocks_y(self):
        return self.cells_y - self.block_cells + 1

    @property
    def blocks_x(self):
        return self.cells_x - self.block_cells + 1

    @property
    def block_dim(self):
        return self.block_cells * self.block_cells * self.n_bins

    @property
    def descriptor_dim(self):
        return self.blocks_y * self.blocks_x * self.block_dim


def _orientation_votes(img: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Gradient magnitude split linearly between the two nearest unsigned
    orientation bins: [H, W, n_bins]. `%` on floats is floor-mod in both
    frameworks (torch.remainder)."""
    dx = imgproc.sep_filter2d(img, _ONE, _DIFF)
    dy = imgproc.sep_filter2d(img, _DIFF, _ONE)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.remainder(torch.atan2(dy, dx), math.pi)  # unsigned [0, pi)
    pos = ang * (n_bins / math.pi)
    b0 = torch.remainder(torch.floor(pos - 0.5), n_bins)
    frac = (pos - 0.5) - torch.floor(pos - 0.5)
    b1 = torch.remainder(b0 + 1, n_bins)
    bins = torch.arange(n_bins, dtype=torch.float32, device=img.device)
    return mag[..., None] * (
        (bins == b0[..., None]) * (1.0 - frac[..., None])
        + (bins == b1[..., None]) * frac[..., None]
    )


def cell_histograms(img: torch.Tensor, cfg: HOGConfig = HOGConfig()) -> torch.Tensor:
    """[H/cell, W/cell, n_bins] gradient-orientation histograms (no gamma,
    no block weighting): per-pixel votes summed per cell."""
    img = img.to(torch.float32)
    h, w = img.shape
    hc, wc = h // cfg.cell, w // cfg.cell
    votes = _orientation_votes(img[: hc * cfg.cell, : wc * cfg.cell], cfg.n_bins)
    return votes.reshape(hc, cfg.cell, wc, cfg.cell, cfg.n_bins).sum(dim=(1, 3))


def vote_map(img: torch.Tensor, cfg: HOGConfig = HOGConfig()) -> torch.Tensor:
    """Dense per-pixel orientation votes [H, W, n_bins] of the (optionally
    sqrt-gamma-corrected) image (hog.cpp computeGradient)."""
    img = img.to(torch.float32)
    if cfg.gamma:
        img = torch.sqrt(img.clamp(min=0.0))
    return _orientation_votes(img, cfg.n_bins)


def _block_taps(cfg: HOGConfig) -> np.ndarray:
    """Per-axis block filter taps [block_cells, block_px]: the Gaussian
    window times the bilinear cell-interpolation weight; both factorize
    over (y, x) (hog.cpp HOGCache::init:657-846)."""
    b = cfg.block_px
    center = b * 0.5
    g = np.exp(-((np.arange(b) - center) ** 2) / (2.0 * cfg.win_sigma ** 2))
    w = np.zeros((cfg.block_cells, b), np.float32)
    for j in range(b):
        cellpos = (j + 0.5) / cfg.cell - 0.5
        i0 = int(np.floor(cellpos))
        f = cellpos - i0
        if 0 <= i0 < cfg.block_cells:
            w[i0, j] += 1.0 - f
        if 0 <= i0 + 1 < cfg.block_cells:
            w[i0 + 1, j] += f
    return (w * g[None, :]).astype(np.float32)


def _l2hys(feat: torch.Tensor, cfg: HOGConfig) -> torch.Tensor:
    """The reference's L2-Hys (hog.cpp normalizeBlockHistogram:1163,1230):
    scale1 = 1/(sqrt(sum) + 0.1*blockDim), clip, scale2 = 1/(sqrt(sum) + 1e-3)."""
    s1 = 1.0 / (torch.sqrt((feat * feat).sum(-1, keepdim=True)) + 0.1 * cfg.block_dim)
    feat = torch.clamp(feat * s1, max=cfg.l2hys_clip)
    s2 = 1.0 / (torch.sqrt((feat * feat).sum(-1, keepdim=True)) + 1e-3)
    return feat * s2


def block_histograms(img: torch.Tensor, cfg: HOGConfig = HOGConfig()) -> torch.Tensor:
    """[BY, BX, block_dim] L2-Hys block features at block stride = cell,
    with the reference's Gaussian and bilinear weighting. Block-internal
    layout is the reference's (cell_x, cell_y, bin), cx outer."""
    v = vote_map(img, cfg)  # [H, W, bins]
    h, w, nb = v.shape
    taps = torch.as_tensor(_block_taps(cfg), device=v.device)  # [bc, b]
    b, bc, cell = cfg.block_px, cfg.block_cells, cfg.cell
    by = (h - b) // cell + 1
    bx = (w - b) // cell + 1
    x = v.permute(2, 0, 1)[:, None]  # [bins, 1, H, W]
    with no_tf32():
        # y pass: each cell row's taps, sampled at the cell stride
        ypass = F.conv2d(x, taps[:, None, :, None], stride=(cell, 1))  # [bins, bc_y, BY, W]
        # x pass per cell row: [bins, bc_x, BY, BX] each
        outs = [F.conv2d(ypass[:, cy: cy + 1], taps[:, None, None, :], stride=(1, cell))
                for cy in range(bc)]
    stack = torch.stack(outs, dim=2)  # [bins, bc_x, bc_y, BY, BX]
    feat = stack.permute(3, 4, 1, 2, 0).reshape(by, bx, bc * bc * nb)
    return _l2hys(feat, cfg)


def load_opencv_detector(coeffs, device=None) -> tuple[torch.Tensor, float]:
    """Adapt a reference-format HOG SVM vector (getDefaultPeopleDetector,
    hog.cpp:2174: 3780 weights + rho) to this module's (weights, bias).
    The reference orders blocks column-major (hog.cpp:854
    blockData[j*nblocks.height + i]), this module row-major. The weights
    go to the card unless `device="cpu"`."""
    cfg = HOGConfig()
    vec = np.asarray(coeffs, np.float32)
    d = cfg.descriptor_dim
    if vec.size not in (d, d + 1):
        raise ValueError(f"expected {d} or {d + 1} coefficients, got {vec.size}")
    rho = float(vec[d]) if vec.size == d + 1 else 0.0
    w = vec[:d].reshape(cfg.blocks_x, cfg.blocks_y, cfg.block_dim)
    w = w.transpose(1, 0, 2).reshape(-1)
    # detect() (hog.cpp): s = rho + w.x, a hit if s >= threshold
    return torch.as_tensor(np.ascontiguousarray(w), device=resolve_device(device)), rho


def block_features(cells: torch.Tensor, cfg: HOGConfig = HOGConfig()) -> torch.Tensor:
    """[blocks_y, blocks_x, block_dim] L2-Hys-normalized block features
    over a cell grid (block stride = one cell; plain L2 normalize, clip,
    renormalize with eps 1e-6)."""
    hc, wc, _ = cells.shape
    bc = cfg.block_cells
    by, bx = hc - bc + 1, wc - bc + 1
    feat = torch.cat([cells[dy: dy + by, dx: dx + bx, :]
                      for dy in range(bc) for dx in range(bc)], dim=-1)
    eps = 1e-6
    nrm = torch.sqrt((feat * feat).sum(-1, keepdim=True) + eps)
    feat = torch.clamp(feat / nrm, 0.0, cfg.l2hys_clip)
    nrm2 = torch.sqrt((feat * feat).sum(-1, keepdim=True) + eps)
    return feat / nrm2


def compute_descriptor(img, cfg: HOGConfig = HOGConfig(), device=None) -> torch.Tensor:
    """Single-window descriptor [descriptor_dim] of a win_h x win_w image
    (HOGDescriptor::compute analog; row-major block order, see
    load_opencv_detector). A tensor stays on its device; numpy goes to
    the card unless `device="cpu"`."""
    img = _as_image(img, device)
    if tuple(img.shape) != (cfg.win_h, cfg.win_w):
        raise ValueError(f"expected a {cfg.win_h}x{cfg.win_w} window, got {tuple(img.shape)}")
    return block_histograms(img, cfg).reshape(-1)


class Detections(NamedTuple):
    boxes: torch.Tensor  # [K, 4] (x, y, w, h) in original image coords
    scores: torch.Tensor  # [K]
    valid: torch.Tensor  # [K]


def score_map(img: torch.Tensor, weights: torch.Tensor, bias, cfg: HOGConfig = HOGConfig()
              ) -> torch.Tensor:
    """SVM score of every window position (stride = cell): the sliding-
    window classifier as one correlation of the block-feature map."""
    feat = block_histograms(img, cfg)  # [BY, BX, D]
    k = weights.to(feat.device, torch.float32).reshape(cfg.blocks_y, cfg.blocks_x, cfg.block_dim)
    with no_tf32():
        out = F.conv2d(feat.permute(2, 0, 1)[None], k.permute(2, 0, 1)[None])
    return out[0, 0] + bias  # [BY - wby + 1, BX - wbx + 1]


def _as_image(img, device) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img.to(torch.float32)
    return torch.as_tensor(np.asarray(img, np.float32), device=resolve_device(device))


def detect_multi_scale(
    img,
    weights,
    bias: float,
    cfg: HOGConfig = HOGConfig(),
    scale0: float = 1.05,
    n_scales: int = 8,
    hit_threshold: float = 0.0,
    max_detections: int = 64,
    device=None,
) -> Detections:
    """detectMultiScale analog (cudaobjdetect/src/hog.cpp): score every
    scale, threshold and 3x3 NMS on each score map, merge across scales by
    score. Scales stop where the window no longer fits. A tensor image
    stays on its device; numpy goes to the card unless `device="cpu"`.

    A score map smaller than `max_detections` (the last scales of a frame)
    contributes all its positions, padded with invalid entries; the JAX
    function raises there (`lax.top_k` needs k <= n)."""
    img = _as_image(img, device)
    dev = img.device
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    h, w = img.shape
    all_boxes, all_scores, all_valid = [], [], []
    for si in range(n_scales):
        s = scale0 ** si
        sh, sw = int(h / s), int(w / s)
        if sh < cfg.win_h or sw < cfg.win_w:
            break
        scaled = imgproc.resize_bilinear(img, sh, sw) if si else img
        sm = score_map(scaled, weights, bias, cfg)
        keep = (sm > hit_threshold) & imgproc.nms_2d(sm)
        my, mx = sm.shape
        k = min(max_detections, my * mx)
        idx, kmask = masked_top_k(sm.reshape(-1), keep.reshape(-1), k)
        by = (idx // mx).to(torch.float32)
        bx = (idx % mx).to(torch.float32)
        boxes = torch.stack([bx * cfg.cell * s, by * cfg.cell * s,
                             torch.full_like(bx, cfg.win_w * s),
                             torch.full_like(by, cfg.win_h * s)], dim=-1)
        all_boxes.append(boxes)
        all_scores.append(torch.where(kmask, sm.reshape(-1)[idx], -math.inf))
        all_valid.append(kmask)
    if not all_boxes:
        return Detections(boxes=torch.zeros((max_detections, 4), device=dev),
                          scores=torch.full((max_detections,), -math.inf, device=dev),
                          valid=torch.zeros((max_detections,), dtype=torch.bool, device=dev))
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    valid = torch.cat(all_valid)
    k = min(max_detections, scores.shape[0])
    idx, kmask = masked_top_k(scores, valid, k)
    pad = max_detections - k
    return Detections(boxes=F.pad(boxes[idx], (0, 0, 0, pad)),
                      scores=F.pad(scores[idx], (0, pad), value=-math.inf),
                      valid=torch.cat([kmask, kmask.new_zeros(pad)]))
