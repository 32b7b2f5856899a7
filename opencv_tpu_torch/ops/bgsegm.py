"""Background subtraction: MOG2, KNN, GMG and FGD (port of
opencv_tpu/ops/bgsegm.py; video/src/bgfg_gaussmix2.cpp and
cudabgsegm/src/cuda/mog2.cu; video/src/bgfg_KNN.cpp; bgsegm's
BackgroundSubtractorGMG and cudalegacy fgd.cpp).

Each model's state is a few [K, H, W] tensors, and one `apply` is one
elementwise step over every pixel, in the JAX functions' arithmetic.
MOG2 ranks its components by fitness with a stable sort, as `jnp.argsort`
(ties are common on flat ground: components of equal weight and
variance). KNN's random slot and update draws come from a
`torch.Generator`, or are passed in (`slot`, `uniform`): torch cannot
replay `jax.random`, so the tests pass the JAX-drawn ones. Masks from the
same state and draws are equal to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import on_device, resolve_device, true_div


class MOG2State(NamedTuple):
    weights: torch.Tensor  # [K, H, W]
    means: torch.Tensor  # [K, H, W]
    variances: torch.Tensor  # [K, H, W]


class MOG2Config(NamedTuple):
    n_mixtures: int = 5
    history: int = 500
    var_threshold: float = 16.0  # squared Mahalanobis gate
    background_ratio: float = 0.9
    var_init: float = 15.0
    var_min: float = 4.0
    var_max: float = 75.0


def _frame(img, like: torch.Tensor) -> torch.Tensor:
    return on_device(img, like.device).to(torch.float32)


def init_state(img, cfg: MOG2Config = MOG2Config(), device=None) -> MOG2State:
    img = on_device(img, device).to(torch.float32)
    h, w = img.shape
    k = cfg.n_mixtures
    weights = torch.zeros((k, h, w), dtype=torch.float32, device=img.device)
    weights[0] = 1.0
    means = torch.zeros_like(weights)
    means[0] = img
    return MOG2State(weights, means, torch.full_like(weights, cfg.var_init))


def apply(state: MOG2State, img, cfg: MOG2Config = MOG2Config(),
          learning_rate: float | None = None) -> tuple[MOG2State, torch.Tensor]:
    """One frame update. Returns (new_state, foreground_mask [H, W])."""
    alpha = 1.0 / cfg.history if learning_rate is None else learning_rate
    x = _frame(img, state.weights)[None]  # [1, H, W]
    w_, mu, var = state

    d2 = (x - mu) ** 2 / torch.clamp(var, min=1e-6)  # squared Mahalanobis [K, H, W]
    fits = d2 < cfg.var_threshold

    # the matched component = best-fitting among those that fit
    owner = torch.where(fits, d2, torch.full_like(d2, float("inf"))).argmin(0)  # [H, W]
    any_fit = fits.any(0)
    ks = torch.arange(w_.shape[0], device=w_.device)[:, None, None]
    is_owner = (ks == owner[None]) & any_fit[None]

    # weight update: w += alpha*(o - w)
    w_new = w_ + alpha * (is_owner.to(torch.float32) - w_)
    # mean/variance update for the owner
    rho = torch.full_like(w_new, alpha) / torch.clamp(w_new, min=1e-6)
    mu_new = torch.where(is_owner, mu + rho * (x - mu), mu)
    var_new = torch.where(is_owner, var + rho * ((x - mu) ** 2 - var), var)
    var_new = var_new.clamp(cfg.var_min, cfg.var_max)

    # no component fits: replace the weakest with a new one centred on x
    weakest = w_new.argmin(0)
    replace = (~any_fit)[None] & (ks == weakest[None])
    w_new = torch.where(replace, torch.full_like(w_new, alpha), w_new)
    mu_new = torch.where(replace, x.expand_as(mu_new), mu_new)
    var_new = torch.where(replace, torch.full_like(var_new, cfg.var_init), var_new)

    # renormalize
    w_new = w_new / torch.clamp(w_new.sum(0, keepdim=True), min=1e-9)

    # background = top components whose cumulative weight (sorted by
    # weight/sigma fitness) reaches background_ratio
    fitness = w_new / torch.sqrt(var_new)
    order = torch.argsort(-fitness, dim=0, stable=True)  # [K, H, W]
    w_sorted = torch.gather(w_new, 0, order)
    cum = imgproc._block_scan(w_sorted.movedim(0, -1)).movedim(-1, 0)  # XLA's order
    is_bg_sorted = cum - w_sorted < cfg.background_ratio
    # invert the permutation to mark background components
    inv = torch.argsort(order, dim=0, stable=True)
    is_bg = torch.gather(is_bg_sorted, 0, inv)

    fg = ~(fits & is_bg).any(0)
    return MOG2State(w_new, mu_new, var_new), fg


# --------------------------------------------------------------- KNN ---

class KNNState(NamedTuple):
    """Sample bank [S, H, W] for the KNN background model
    (video/src/bgfg_KNN.cpp analog)."""

    samples: torch.Tensor
    step: int  # frame counter (drives cyclic replacement)


def knn_init(img, n_samples: int = 10, device=None) -> KNNState:
    img = on_device(img, device).to(torch.float32)
    return KNNState(samples=img[None].repeat(n_samples, 1, 1), step=0)


def knn_apply(state: KNNState, img, gen: torch.Generator | None = None,
              dist_threshold: float = 20.0, k_needed: int = 2, update_prob: float = 0.2,
              slot: torch.Tensor | None = None,
              uniform: torch.Tensor | None = None) -> tuple[KNNState, torch.Tensor]:
    """One frame of the KNN background subtractor: foreground when fewer
    than k samples lie within dist_threshold; background pixels refresh a
    random sample slot with probability update_prob. `slot` (i64 [H, W]
    in [0, S)) and `uniform` (f32 [H, W] in [0, 1)) are drawn from `gen`
    unless given."""
    x = _frame(img, state.samples)[None]
    s = state.samples.shape[0]
    shape = x.shape[1:]
    close = (state.samples - x).abs() < dist_threshold  # [S, H, W]
    fg = close.sum(0) < k_needed
    if gen is None and (slot is None or uniform is None):
        raise ValueError("knn_apply: pass a torch.Generator or both `slot` and `uniform`")
    if slot is None:
        slot = torch.randint(0, s, shape, generator=gen, device=gen.device)
    if uniform is None:
        uniform = torch.rand(shape, generator=gen, device=gen.device)
    slot = on_device(slot, x.device)
    do = (~fg) & (on_device(uniform, x.device) < update_prob)
    ss = torch.arange(s, device=x.device)[:, None, None]
    replace = (ss == slot[None]) & do[None]
    samples = torch.where(replace, x.expand_as(state.samples), state.samples)
    return KNNState(samples=samples, step=state.step + 1), fg


# --------------------------------------------------------------- GMG ---

class GMGState(NamedTuple):
    """Godbehere-Matsukawa-Goldberg background model (cudalegacy GMG /
    bgsegm's BackgroundSubtractorGMG): per-pixel quantized-colour
    histograms with Bayesian foreground posterior, trained on the first
    `n_init_frames` frames."""
    hist: torch.Tensor  # [B, H, W] bin weights
    frame_idx: int


def gmg_init(h: int, w: int, n_bins: int = 16, device=None) -> GMGState:
    return GMGState(hist=torch.zeros((n_bins, h, w), device=resolve_device(device)), frame_idx=0)


def _onehot_bins(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[B, H, W] f32 one-hot of the bin of x / 256 * n_bins."""
    b = (true_div(x, 256.0) * n_bins).to(torch.int64).clamp(0, n_bins - 1)
    bins = torch.arange(n_bins, device=x.device)[:, None, None]
    return (bins == b[None]).to(torch.float32)


def gmg_apply(state: GMGState, img, n_init_frames: int = 30, learning_rate: float = 0.025,
              decision_threshold: float = 0.8) -> tuple[GMGState, torch.Tensor]:
    """One frame: returns (state, fg mask [H,W] bool). During the first
    n_init_frames only the model trains (mask = all background)."""
    n_bins = state.hist.shape[0]
    x = _frame(img, state.hist).clamp(0.0, 255.0)
    onehot = _onehot_bins(x, n_bins)
    total = state.hist.sum(0)
    w_cur = (state.hist * onehot).sum(0)
    p_bg = w_cur / torch.clamp(total, min=1e-6)
    if state.frame_idx < n_init_frames:
        # train: accumulate
        return GMGState(hist=state.hist + onehot, frame_idx=state.frame_idx + 1), torch.zeros_like(p_bg, dtype=torch.bool)
    fg = (1.0 - p_bg) > decision_threshold
    # run: blend into background for bg pixels only
    blend = torch.where(fg[None], torch.zeros_like(state.hist[:1]), torch.full_like(state.hist[:1], learning_rate))
    hist = state.hist * (1.0 - blend) + onehot * blend
    return GMGState(hist=hist, frame_idx=state.frame_idx + 1), fg


# --------------------------------------------------------------- FGD ---

class FGDState(NamedTuple):
    """Li et al. FGD (cudalegacy fgd.cpp): Bayes decision between learned
    background/foreground colour-feature statistics plus a maintained
    reference background image."""
    bg: torch.Tensor  # [H, W] reference background
    hist_bg: torch.Tensor  # [B, H, W] stats of colours seen as background
    hist_fg: torch.Tensor  # [B, H, W] stats of colours seen as foreground


def fgd_init(img, n_bins: int = 32, device=None) -> FGDState:
    img = on_device(img, device).to(torch.float32)
    h, w = img.shape
    z = torch.zeros((n_bins, h, w), dtype=torch.float32, device=img.device)
    return FGDState(bg=img, hist_bg=z, hist_fg=z.clone())


def fgd_apply(state: FGDState, img, delta: float = 12.0, alpha: float = 0.02,
              prior_fg: float = 0.15) -> tuple[FGDState, torch.Tensor]:
    """One frame: change detection vs the reference background, Bayes
    re-classification from the learned colour tables, model update."""
    n_bins = state.hist_bg.shape[0]
    x = _frame(img, state.bg)
    changed = (x - state.bg).abs() > delta
    onehot = _onehot_bins(x, n_bins)
    w_bg = (state.hist_bg * onehot).sum(0)
    w_fg = (state.hist_fg * onehot).sum(0)
    # Bayes veto: a changed pixel is foreground unless its colour has a
    # strong background history (the tables absorb dynamic background,
    # not novel colours, which default to foreground)
    fg = changed & (prior_fg * (w_fg + 1.0) > (1 - prior_fg) * w_bg)
    hist_bg = state.hist_bg * (1 - alpha) + onehot * alpha * (~fg)[None]
    hist_fg = state.hist_fg * (1 - alpha) + onehot * alpha * fg[None]
    bg = torch.where(fg, state.bg, state.bg * (1 - alpha) + x * alpha)
    return FGDState(bg=bg, hist_bg=hist_bg, hist_fg=hist_fg), fg
