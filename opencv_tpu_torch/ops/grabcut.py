"""GrabCut interactive foreground extraction (port of
opencv_tpu/ops/grabcut.py; reference modules/imgproc/src/grabcut.cpp):
per-class 5-component full-covariance GMMs over RGB, 8-connected
contrast-sensitive N-links (beta from the mean squared neighbour
difference, gamma 50, diagonals gamma/sqrt(2)), and an assign / learn /
cut iteration through the push-relabel min-cut of ops/graphcut.py.

All pixel stages are dense masked tensor ops with TF32 off. Their large
sums (beta, the k-means and GMM moments) and the 3x3 inverses and
log-determinants are ordered by the library, so the capacities agree
with the JAX package's to ulps and the final mask to >= 99.9 % of the
pixels (the min-cut itself is exact on equal capacities).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.device import no_tf32, resolve_device
from opencv_tpu_torch.ops.graphcut import _DIRS8, _shift, min_cut_grid_stats

# mask values (cv2 GrabCutClasses)
GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3

_K = 5  # GMM components per class (grabcut.cpp GMM::componentsCount)
_GAMMA = 50.0
_LAMBDA = 9 * _GAMMA
_LOG_2PI_3 = float(3 * np.log(np.float32(2 * np.pi)))


def _calc_beta(chw: torch.Tensor) -> torch.Tensor:
    """beta = 1/(2 * mean ||c_i - c_j||^2) over the 4 unique edge types
    with the exact edge count (grabcut.cpp:236-274). chw: [3, H, W]."""
    h, w = chw.shape[1:]
    dev = chw.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    for dy, dx in ((0, -1), (-1, -1), (-1, 0), (-1, 1)):
        nb = _shift(chw, dy, dx, 0.0)
        valid_y = (ar_h + dy >= 0) & (ar_h + dy < h)
        valid_x = (ar_w + dx >= 0) & (ar_w + dx < w)
        m = (valid_y[:, None] & valid_x[None, :]).to(chw.dtype)
        total = total + (m[None] * (chw - nb) ** 2).sum()
    n_edges = 4 * w * h - 3 * w - 3 * h + 2
    beta = total / torch.tensor(float(n_edges), device=dev)
    return torch.where(beta <= 1e-12, 0.0, 1.0 / (2.0 * beta))


def _n_weights(chw: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """[8, H, W] contrast-sensitive N-link capacities toward _DIRS8."""
    caps = []
    for dy, dx in _DIRS8:
        g = _GAMMA / np.sqrt(2.0) if (dy != 0 and dx != 0) else _GAMMA
        nb = _shift(chw, dy, dx, 1e9)  # huge difference outside -> ~0 capacity
        d2 = ((chw - nb) ** 2).sum(0)
        caps.append(float(g) * torch.exp(-beta * d2))
    return torch.stack(caps)


def _kmeans(x: torch.Tensor, w: torch.Tensor, k: int, iters: int = 10) -> torch.Tensor:
    """Weighted k-means on [N, 3] with binary weights w, seeded from the
    weighted quantiles of luminance (a stable argsort, as jnp.argsort)."""
    lum = x @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=x.device)
    order = torch.argsort(torch.where(w > 0, lum, float("inf")), stable=True)
    n_valid = (w > 0).sum().to(torch.int64).clamp(min=1)
    picks = (torch.arange(k, device=x.device) * n_valid) // k + n_valid // (2 * k)
    centers = x[order[picks]]
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        oh = torch.nn.functional.one_hot(d.argmin(1), k).to(torch.float32) * w[:, None]
        cnt = oh.sum(0).clamp(min=1e-6)
        centers = (oh.T @ x) / cnt[:, None]
    return ((x[:, None, :] - centers[None]) ** 2).sum(-1).argmin(1)


class _GMM(NamedTuple):
    """Per-class GMM parameters fitted from masked assignments."""

    pi: torch.Tensor  # [K]
    mean: torch.Tensor  # [K, 3]
    inv_cov: torch.Tensor  # [K, 3, 3]
    log_det: torch.Tensor  # [K]

    @staticmethod
    def fit(x: torch.Tensor, w: torch.Tensor, comp: torch.Tensor) -> "_GMM":
        """x [N, 3], w [N] binary, comp [N] in [0, K)."""
        oh = torch.nn.functional.one_hot(comp, _K).to(torch.float32) * w[:, None]
        cnt = oh.sum(0)
        safe = cnt.clamp(min=1e-6)
        mean = (oh.T @ x) / safe[:, None]
        xc = x[:, None, :] - mean[None]  # [N, K, 3]
        cov = torch.einsum("nk,nki,nkj->kij", oh, xc, xc) / safe[:, None, None]
        # the reference's variance floor (grabcut.cpp GMM::endLearning)
        cov = cov + torch.eye(3, device=x.device) * 0.01
        inv_cov = torch.linalg.inv_ex(cov)[0]
        log_det = torch.linalg.slogdet(cov)[1]
        pi = cnt / cnt.sum().clamp(min=1e-6)
        return _GMM(pi, mean, inv_cov, log_det)

    def comp_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """[N, K] per-component log N(x; mu_k, Sigma_k) + log pi_k."""
        xc = x[:, None, :] - self.mean[None]
        maha = torch.einsum("nki,kij,nkj->nk", xc, self.inv_cov, xc)
        return self.pi.clamp(min=1e-12).log()[None] - 0.5 * (maha + self.log_det[None] + _LOG_2PI_3)

    def neg_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """-log sum_k pi_k N_k(x): the data term."""
        return -torch.logsumexp(self.comp_log_prob(x), dim=1)


class GrabCut(NamedTuple):
    mask: torch.Tensor  # i32 [H, W] of GC_* values
    sweeps: list  # push-relabel sweeps of each iteration's min-cut
    capped: list  # whether each min-cut stopped at the 4096-sweep cap


def grab_cut_stats(img, mask=None, rect=None, iter_count: int = 5, device=None) -> GrabCut:
    """`grab_cut` with each iteration's min-cut sweeps and cap flag."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    dev = img.device
    h, w = img.shape[:2]
    if mask is None:
        assert rect is not None
        x0, y0, rw, rh = rect
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        inside = (xx >= x0) & (xx < x0 + rw) & (yy >= y0) & (yy < y0 + rh)
        mask = torch.where(inside, GC_PR_FGD, GC_BGD).to(torch.int32)
    else:
        mask = torch.as_tensor(mask, device=dev).to(torch.int32)

    sweeps, capped = [], []
    with no_tf32():
        x = img.reshape(-1, 3)
        chw = img.permute(2, 0, 1)
        nw = _n_weights(chw, _calc_beta(chw))
        fg = ((mask == GC_FGD) | (mask == GC_PR_FGD)).reshape(-1)
        comp_fg = _kmeans(x, fg.to(torch.float32), _K)
        comp_bg = _kmeans(x, (~fg).to(torch.float32), _K)
        hard_bgd = mask == GC_BGD
        hard_fgd = mask == GC_FGD
        for _ in range(iter_count):
            gmm_fg = _GMM.fit(x, fg.to(torch.float32), comp_fg)
            gmm_bg = _GMM.fit(x, (~fg).to(torch.float32), comp_bg)
            # t-links: PR pixels get the GMM data terms; hard pixels lambda walls
            d_fg = gmm_fg.neg_log_prob(x).reshape(h, w)
            d_bg = gmm_bg.neg_log_prob(x).reshape(h, w)
            src = torch.where(hard_bgd, 0.0, torch.where(hard_fgd, _LAMBDA, d_bg))
            snk = torch.where(hard_bgd, _LAMBDA, torch.where(hard_fgd, 0.0, d_fg))
            cut = min_cut_grid_stats(src, snk, nw)  # True = source = fg
            sweeps.append(cut.sweeps)
            capped.append(cut.capped)
            mask = torch.where(hard_bgd | hard_fgd, mask,
                               torch.where(cut.labels, GC_PR_FGD, GC_PR_BGD).to(torch.int32))
            fg = ((mask == GC_FGD) | (mask == GC_PR_FGD)).reshape(-1)
            # re-assign components under the refreshed masks (assignGMMs)
            comp_fg = gmm_fg.comp_log_prob(x).argmax(1)
            comp_bg = gmm_bg.comp_log_prob(x).argmax(1)
    return GrabCut(mask, sweeps, capped)


def grab_cut(img, mask=None, rect=None, iter_count: int = 5, device=None) -> torch.Tensor:
    """cv2.grabCut semantics: img [H, W, 3] f32 (0..255); either `rect`
    (x, y, w, h: inside GC_PR_FGD, outside GC_BGD) or an explicit `mask`
    of GC_* values. Returns the refined mask (same coding), i32 on the
    device. Runs on the card unless `device="cpu"`."""
    return grab_cut_stats(img, mask, rect, iter_count, device=device).mask
