"""Decision trees, random forests and boosting (port of
opencv_tpu/ml/trees.py).

Reference: ml/src/tree.cpp (CART), rtrees.cpp (random forest), boost.cpp
(Discrete AdaBoost), and gradient boosting.

The JAX design is kept: the histogram method with level-synchronous
growth over dense node arrays. Features are binned to B quantile
buckets; one level is one scatter-add building the [nodes, F, B, C]
class histogram, a cumulative sum over bins and a Gini argmax that picks
(feature, bin) for every node of the level at once; a tree is a
fixed-shape heap (children 2i+1, 2i+2); prediction is `depth` gather
steps. A forest's trees grow together, FOREST_CHUNK at a time, as the
JAX package's `vmap` grows them.

Where the arithmetic follows XLA's CPU order, so that the CPU equals the
JAX package and the card equals the CPU:
- `quantile_bins` takes jnp.percentile's linear interpolation as XLA
  compiles it: the quantiles i * (1/B * 100) (the linspace's constants
  folded), the position q * (0.01 * (n - 1)), and the interpolation's
  multiply-add fused (low * w_low + round(high * w_high), one rounding;
  taken in f64 and rounded once);
- the histograms add each sample's mass into its bin in sample order, as
  XLA's CPU scatter does: `index_put_(accumulate=True)` under
  deterministic algorithms, which sorts the bin indices stably and adds
  each bin's updates in that order on either device (CUDA's atomic
  scatter would add in no fixed order, and AdaBoost's and GBT's weights
  are not integers);
- the cumulative sum over bins is `imgproc._block_scan`, sums over
  classes and samples `imgproc.xla_sum`;
- boosting's exp, log and sigmoid run in f64 and are rounded once, so
  both devices get the same f32 weights (XLA's f32 exp is not correctly
  rounded: the weights differ from JAX's in the last bit, and the split
  choices with them only at near-ties).

Random draws are injected: the forest's Poisson weights and feature
masks come from `draws` (e.g. JAX's) or from a `torch.Generator`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from opencv_tpu_torch.core.imgproc import _block_scan, xla_sum
from opencv_tpu_torch.device import true_div


class Tree(NamedTuple):
    feature: torch.Tensor  # [M] i32 split feature per node
    bin: torch.Tensor  # [M] i32 split bin (go left if xb <= bin)
    value: torch.Tensor  # [M, C] class distribution at the node
    is_leaf: torch.Tensor  # [M] bool
    thresholds: torch.Tensor  # [F, B-1] bin edges (shared across forest)


@contextlib.contextmanager
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def _scatter_rows(n_rows: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros [n_rows, C] with each row of `vals` added at `idx`, every
    bin's updates in the order they come (XLA's CPU scatter-add)."""
    out = torch.zeros((n_rows, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    with _deterministic():
        out.index_put_((idx,), vals, accumulate=True)
    return out


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def quantile_bins(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-feature quantile bin edges [F, B-1] (jnp.percentile, linear)."""
    n = x.shape[0]
    qs = torch.arange(1, n_bins, dtype=torch.float32) * (_f32(1.0) / _f32(n_bins) * _f32(100.0))
    q = qs * (_f32(1.0) / _f32(100.0) * _f32(n - 1))
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    low = low.clamp(0, n - 1).long().to(x.device)
    high = high.clamp(0, n - 1).long().to(x.device)
    s = torch.sort(x.float(), dim=0).values
    lv, hv = s[low], s[high]  # [B-1, F]
    w_low, w_high = w_low.to(x.device)[:, None], w_high.to(x.device)[:, None]
    out = (lv.double() * w_low.double() + (hv * w_high).double()).float()
    return out.T.contiguous()


def bin_features(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """x [N,F] -> bin indices [N,F] in [0, B)."""
    return (x[:, :, None] > thresholds[None]).sum(dim=-1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c with one rounding (taken in f64), as XLA's CPU code
    contracts a multiply feeding an add."""
    return (a.double() * b.double() + c.double()).float()


def _sum_squares(h: torch.Tensor) -> torch.Tensor:
    """sum(h**2, -1) as the jitted JAX tree computes it: the squares
    accumulated left to right, each by a fused multiply-add."""
    out = torch.zeros(h.shape[:-1], dtype=h.dtype, device=h.device)
    for k in range(h.shape[-1]):
        out = _fma(h[..., k], h[..., k], out)
    return out


def _gini_gain(hist_left: torch.Tensor, hist_right: torch.Tensor) -> torch.Tensor:
    """Weighted Gini impurity decrease proxy (higher = better): -(nl*gini_l
    + nr*gini_r) of the [..., C] class masses, with the jitted JAX
    function's fused multiply-adds (sums of squares, and nl*gini_l added
    to the rounded nr*gini_r): AdaBoost's weighted splits come in
    near-ties, which one rounding decides."""
    nl = xla_sum(hist_left)
    nr = xla_sum(hist_right)
    gl = 1.0 - _sum_squares(hist_left) / torch.clamp(nl * nl, min=1e-12)
    gr = 1.0 - _sum_squares(hist_right) / torch.clamp(nr * nr, min=1e-12)
    return -_fma(nl, gl, nr * gr)


def fit_tree(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor | None = None,
             depth: int = 6, n_bins: int = 16, n_classes: int = 2,
             feature_mask: torch.Tensor | None = None, thresholds: torch.Tensor | None = None,
             min_gain: float = 1e-6) -> Tree:
    """Grow one CART classification tree (DTrees::train analog)."""
    n, f = x.shape
    if weights is None:
        weights = torch.ones(n, device=x.device)
    if feature_mask is None:
        feature_mask = torch.ones(f, dtype=torch.bool, device=x.device)
    if thresholds is None:
        thresholds = quantile_bins(x, n_bins)
    trees = _grow(x, y, weights[None], feature_mask[None], depth, n_bins, n_classes, thresholds,
                  min_gain)
    return _tree_at(trees, 0)


def _grow(x, y, weights, feature_mask, depth, n_bins, n_classes, thresholds, min_gain) -> Tree:
    """Grow T trees at once on the same samples (the JAX forest's vmap):
    weights [T, N], feature_mask [T, F]; each tree's arithmetic is the
    one-tree arithmetic, in the same order. Returns the stacked trees."""
    n, f = x.shape
    t_n = weights.shape[0]
    dev = x.device
    xb = bin_features(x, thresholds)  # [N, F]
    m = 2 ** (depth + 1) - 1
    feat = torch.zeros((t_n, m), dtype=torch.int32, device=dev)
    sbin = torch.full((t_n, m), n_bins, dtype=torch.int32, device=dev)  # everything goes left
    is_leaf = torch.zeros((t_n, m), dtype=torch.bool, device=dev)
    value = torch.zeros((t_n, m, n_classes), device=dev)
    onehot_y = torch.nn.functional.one_hot(y.long(), n_classes).float()[None] * weights[:, :, None]
    xb_t = xb[None].expand(t_n, n, f)
    ar_f = torch.arange(f, device=dev)
    ar_t = torch.arange(t_n, device=dev)[:, None]
    neg_inf = torch.tensor(-float("inf"), device=dev)

    node_id = torch.zeros((t_n, n), dtype=torch.int64, device=dev)
    for level in range(depth):
        n_nodes = 2 ** level
        base = n_nodes - 1
        size = n_nodes * f * n_bins
        local = node_id - base
        active = (local >= 0) & (local < n_nodes)
        idx = ((local[:, :, None] * f + ar_f) * n_bins + xb[None]).clamp(0, size - 1)
        idx = (idx + ar_t[:, :, None] * size).reshape(-1)
        wrep = (onehot_y * active[:, :, None]).repeat_interleave(f, dim=1).reshape(-1, n_classes)
        hist = _scatter_rows(t_n * size, idx, wrep).reshape(t_n, n_nodes, f, n_bins, n_classes)

        left = _block_scan(hist.transpose(3, 4)).transpose(3, 4)  # mass with bin <= b
        total = left[..., -1:, :]
        right = total - left
        gain = _gini_gain(left, right)  # [T, nodes, F, B]
        # never split on the last bin (empty right side) or masked features
        gain[..., -1] = -float("inf")
        gain = torch.where(feature_mask[:, None, :, None], gain, neg_inf)

        tot_node = total[:, :, 0, 0, :]  # [T, nodes, C]
        parent = _gini_gain(tot_node, torch.zeros_like(tot_node))
        flat = gain.reshape(t_n, n_nodes, -1)
        best = torch.argmax(flat, dim=2)
        best_gain = flat.gather(2, best[:, :, None])[:, :, 0]
        bf = (best // n_bins).int()
        bb = (best % n_bins).int()
        # min-samples stop on raw counts (AdaBoost's weights sum to 1)
        cnt = torch.bincount((ar_t * n_nodes + local.clamp(0, n_nodes - 1)).reshape(-1),
                             weights=active.reshape(-1).double(),
                             minlength=t_n * n_nodes).reshape(t_n, n_nodes)
        rel_gain = (best_gain - parent) / torch.clamp(parent.abs(), min=1e-12)
        leaf_here = (rel_gain <= min_gain) | (cnt < 2)

        ids = slice(base, base + n_nodes)
        feat[:, ids] = torch.where(leaf_here, 0, bf).int()
        sbin[:, ids] = torch.where(leaf_here, n_bins, bb).int()
        is_leaf[:, ids] = leaf_here
        value[:, ids] = tot_node

        # route samples: frozen at leaves, else to children
        node_feat = feat.gather(1, node_id).long()
        go_right = xb_t.gather(2, node_feat[:, :, None])[:, :, 0] > sbin.gather(1, node_id)
        child = 2 * node_id + 1 + go_right.long()
        frozen = is_leaf.gather(1, node_id) | ~active
        node_id = torch.where(frozen, node_id, child)

    # final level: everything is a leaf
    n_nodes = 2 ** depth
    base = n_nodes - 1
    local = node_id - base
    active = (local >= 0) & (local < n_nodes)
    idx = (ar_t * n_nodes + local.clamp(0, n_nodes - 1)).reshape(-1)
    hist = _scatter_rows(t_n * n_nodes, idx, (onehot_y * active[:, :, None]).reshape(-1, n_classes))
    value[:, base:] = hist.reshape(t_n, n_nodes, n_classes)
    is_leaf[:, base:] = True
    return Tree(feat, sbin, value, is_leaf, thresholds[None].expand(t_n, *thresholds.shape))


def _leaf_values(tree: Tree, x: torch.Tensor, depth: int) -> torch.Tensor:
    """[N, C] class masses of the leaf each sample reaches."""
    xb = bin_features(x, tree.thresholds)
    n = x.shape[0]
    ar = torch.arange(n, device=x.device)
    node = torch.zeros(n, dtype=torch.int64, device=x.device)
    for _ in range(depth):
        go_right = xb[ar, tree.feature[node].long()] > tree.bin[node]
        child = 2 * node + 1 + go_right.long()
        node = torch.where(tree.is_leaf[node], node, child)
    return tree.value[node]


def tree_predict_proba(tree: Tree, x: torch.Tensor, depth: int) -> torch.Tensor:
    """Class distribution [N, C] by `depth` gather steps."""
    v = _leaf_values(tree, x, depth)
    return v / torch.clamp(xla_sum(v)[:, None], min=1e-12)


def _tree_at(trees: Tree, t: int) -> Tree:
    return Tree(*(a[t] for a in trees))


def _stack(trees: list[Tree]) -> Tree:
    return Tree(*(torch.stack(fs) for fs in zip(*trees)))


FOREST_CHUNK = 25  # trees grown together (the histograms of a level hold chunk x nodes x F x B x C)


class Forest(NamedTuple):
    trees: Tree  # stacked: leading axis = tree
    depth: int
    n_classes: int


def forest_draws(gen: torch.Generator | None, n: int, f: int, n_trees: int,
                 feature_frac: float) -> tuple[torch.Tensor, torch.Tensor]:
    """A forest's random draws, on the generator's device: Poisson(1)
    bootstrap weights [T, N] and Bernoulli(feature_frac) feature masks
    [T, F] with one feature forced on in each tree."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    w = torch.poisson(torch.ones((n_trees, n), device=gen.device), generator=gen)
    fm = torch.rand((n_trees, f), generator=gen, device=gen.device) < feature_frac
    forced = torch.randint(0, f, (n_trees,), generator=gen, device=gen.device)
    fm[torch.arange(n_trees, device=gen.device), forced] = True
    return w, fm


def fit_random_forest(gen: torch.Generator | None, x: torch.Tensor, y: torch.Tensor,
                      n_trees: int = 16, depth: int = 6, n_bins: int = 16, n_classes: int = 2,
                      feature_frac: float = 0.7, draws=None) -> Forest:
    """Random forest (RTrees::train analog): Poisson(1) bootstrap weights
    and per-tree Bernoulli feature masks, from `draws` (weights [T, N],
    masks [T, F]) or from `gen`."""
    thresholds = quantile_bins(x, n_bins)
    if draws is None:
        draws = forest_draws(gen, x.shape[0], x.shape[1], n_trees, feature_frac)
    w_all = torch.as_tensor(draws[0]).float().to(x.device)
    fm_all = torch.as_tensor(draws[1]).bool().to(x.device)
    chunks = [_grow(x, y, w_all[t:t + FOREST_CHUNK], fm_all[t:t + FOREST_CHUNK], depth, n_bins,
                    n_classes, thresholds, 1e-6) for t in range(0, n_trees, FOREST_CHUNK)]
    trees = Tree(*(torch.cat(fs) for fs in zip(*chunks)))
    return Forest(trees=trees, depth=depth, n_classes=n_classes)


def forest_predict_proba(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Mean over the trees of their class distributions, summed tree by
    tree."""
    n_trees = forest.trees.feature.shape[0]
    acc = tree_predict_proba(_tree_at(forest.trees, 0), x, forest.depth)
    for t in range(1, n_trees):
        acc = acc + tree_predict_proba(_tree_at(forest.trees, t), x, forest.depth)
    return true_div(acc, n_trees)


class Boosted(NamedTuple):
    trees: Tree  # stacked stumps/shallow trees
    alpha: torch.Tensor  # [T] stage weights
    depth: int


def _hard(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p[:, 1] > p[:, 0], 1.0, -1.0)


def fit_adaboost(x: torch.Tensor, y: torch.Tensor, n_rounds: int = 32, depth: int = 2,
                 n_bins: int = 16) -> Boosted:
    """Discrete AdaBoost over shallow trees (Boost::train with
    BOOST_DISCRETE, ml/src/boost.cpp). y in {0, 1}."""
    n = x.shape[0]
    dev = x.device
    thresholds = quantile_bins(x, n_bins)
    w = torch.full((n,), 1.0 / n, device=dev)
    ys = 2.0 * y.float() - 1.0
    trees, alphas = [], []
    for _ in range(n_rounds):
        t = fit_tree(x, y, w, depth=depth, n_bins=n_bins, n_classes=2, thresholds=thresholds)
        h = _hard(tree_predict_proba(t, x, depth))
        err = xla_sum(w * (h != ys).float()) / torch.clamp(xla_sum(w), min=1e-12)
        err = torch.clamp(err, 1e-6, 1 - 1e-6)
        a = (0.5 * torch.log((1 - err.double()) / err.double())).float()
        w = w * torch.exp((-a * ys * h).double()).float()
        w = w / torch.clamp(xla_sum(w), min=1e-12)
        trees.append(t)
        alphas.append(a)
    return Boosted(trees=_stack(trees), alpha=torch.stack(alphas), depth=depth)


def adaboost_decision(model: Boosted, x: torch.Tensor) -> torch.Tensor:
    """Signed decision values [N] (positive = class 1), stage by stage."""
    out = torch.zeros(x.shape[0], device=x.device)
    for t in range(model.alpha.shape[0]):
        out = out + model.alpha[t] * _hard(tree_predict_proba(_tree_at(model.trees, t), x,
                                                              model.depth))
    return out


class GBT(NamedTuple):
    """Gradient-boosted trees for binary classification: shallow trees fit
    to logistic-loss gradients, shrunk by a learning rate."""
    trees: Tree  # stacked
    f0: torch.Tensor  # initial log-odds
    lr: float
    depth: int


def _tree_value(tree: Tree, x: torch.Tensor, depth: int) -> torch.Tensor:
    """Signed leaf value from the 2-class mass encoding (neg, pos)."""
    v = _leaf_values(tree, x, depth)
    tot = torch.clamp(v[:, 0] + v[:, 1], min=1e-8)
    return (v[:, 1] - v[:, 0]) / tot


def fit_gbt(x: torch.Tensor, y: torch.Tensor, n_rounds: int = 40, depth: int = 3,
            lr: float = 0.3, n_bins: int = 16) -> GBT:
    """Binary logistic gradient boosting. y in {0, 1}. Each round fits a
    2-class tree to sign(r) with weights |r| + 1e-8 (the residual r = y -
    sigmoid(f)), and its leaf value is the mass-weighted mean sign."""
    thresholds = quantile_bins(x, n_bins)
    yf = y.float()
    p0 = torch.clamp(true_div(xla_sum(yf), yf.shape[0]), 1e-3, 1 - 1e-3)
    f = torch.full_like(yf, float(torch.log(p0.double() / (1 - p0.double())).float()))
    f0 = f[0]
    trees = []
    for _ in range(n_rounds):
        r = yf - torch.sigmoid(f.double()).float()  # negative gradient of the logistic loss
        t = fit_tree(x, (r > 0).long(), torch.abs(r) + 1e-8, depth=depth, n_bins=n_bins,
                     n_classes=2, thresholds=thresholds)
        trees.append(t)
        f = f + lr * _tree_value(t, x, depth)
    return GBT(trees=_stack(trees), f0=f0, lr=lr, depth=depth)


def gbt_decision(model: GBT, x: torch.Tensor) -> torch.Tensor:
    """Log-odds [N] (positive -> class 1), trees summed in order."""
    acc = torch.zeros(x.shape[0], device=x.device)
    for t in range(model.trees.feature.shape[0]):
        acc = acc + _tree_value(_tree_at(model.trees, t), x, model.depth)
    return model.f0 + model.lr * acc
