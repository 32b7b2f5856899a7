"""Classic classifiers (reference `ml` module analogs; port of
opencv_tpu/ml/classifiers.py): k-NN (ml/src/knearest.cpp), linear SVM
(ml/src/svm.cpp, linear kernel), logistic regression (ml/src/lr.cpp),
the RPROP MLP (ann_mlp.cpp), the kernel SVM, Gaussian naive Bayes
(nbayes.cpp) and SVMSGD (svmsgd.cpp).

The JAX design is kept: training is full-batch and fixed-trip (gradient
descent, Newton, RPROP, projected gradient ascent on the dual), and
inference is one matmul. Its `fori_loop` and `scan` bodies are Python
loops over the same updates; gradients are written out where the
objective is convex and small (the squared hinge), autograd carries the
MLP. Every matrix product runs inside `device.no_tf32()` (the JAX code's
Precision.HIGHEST, and exact f32 on the CPU).

Random draws are injected: `train_mlp` takes its initial weights' normal
draws as `init` (else draws them from a `torch.Generator`), and
`train_svmsgd` its sample indices as `indices`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_tpu_torch.device import no_tf32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with no_tf32():
        return a @ b


# ---------- k-NN ----------

KNN_QUERY_CHUNK = 2048  # queries a distance block holds (a block is chunk x train)


def knn_classify(train_x: torch.Tensor, train_y: torch.Tensor, query_x: torch.Tensor,
                 k: int = 5, n_classes: int | None = None) -> torch.Tensor:
    """Majority vote over the k nearest neighbours (findNearest analog).

    The k nearest are taken by a stable sort of the distances, not
    `torch.topk`: on tied distances `lax.top_k` keeps the lower training
    index, and only a stable sort promises that."""
    if n_classes is None:
        n_classes = int(train_y.max()) + 1
    t2 = torch.sum(train_x * train_x, dim=1)[None, :]
    ar = torch.arange(n_classes, device=train_y.device)
    out = []
    for s in range(0, query_x.shape[0], KNN_QUERY_CHUNK):
        q = query_x[s:s + KNN_QUERY_CHUNK]
        x2 = torch.sum(q * q, dim=1, keepdim=True)
        d = x2 + t2 - 2.0 * _mm(q, train_x.T)
        idx = torch.sort(-d, dim=1, descending=True, stable=True).indices[:, :k]
        votes = train_y[idx]  # [Q, k]
        counts = (votes[:, :, None] == ar[None, None, :]).sum(dim=1)
        out.append(torch.argmax(counts, dim=1))
    return torch.cat(out)


# ---------- linear SVM ----------

class LinearModel(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor


def train_linear_svm(x: torch.Tensor, y: torch.Tensor, c: float = 1.0, iters: int = 1000,
                     lr: float = 0.1) -> LinearModel:
    """L2-regularized SQUARED hinge loss, full-batch GD. y in {-1, +1}.
    The gradient of 0.5/(c n) |w|^2 + mean(max(0, 1 - y (x.w + b))^2) is
    written out: w/(c n) - 2/n x^T (y h), -2/n sum(y h), h the hinge."""
    n, d = x.shape
    y = y.float()
    w = torch.zeros(d, device=x.device)
    b = torch.zeros((), device=x.device)
    nt = torch.full((), float(n), device=x.device)
    reg = torch.full((), 1.0 / (c * n), device=x.device)
    # the JAX loop's f32 step lr / (1 + 0.01 i)
    it = torch.arange(iters, dtype=torch.float32)
    steps = (torch.tensor(lr, dtype=torch.float32) / (1.0 + 0.01 * it)).to(x.device)
    for i in range(iters):
        margins = y * (_mm(x, w) + b)
        yh = y * torch.clamp(1.0 - margins, min=0.0)
        gw = reg * w - 2.0 * _mm(x.T, yh) / nt
        gb = -2.0 * yh.sum() / nt
        w = w - steps[i] * gw
        b = b - steps[i] * gb
    return LinearModel(w=w, b=b)


def svm_predict(model: LinearModel, x: torch.Tensor) -> torch.Tensor:
    """Signed decision values (threshold at 0 for labels)."""
    return _mm(x, model.w) + model.b


# ---------- logistic regression ----------

def train_logistic_regression(x: torch.Tensor, y: torch.Tensor, l2: float = 1e-3,
                              iters: int = 100) -> LinearModel:
    """Binary logistic regression by Newton's method. y in {0, 1}."""
    n, d = x.shape
    xb = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)], dim=1)
    y = y.float()
    w = torch.zeros(d + 1, device=x.device)
    eye = torch.eye(d + 1, device=x.device)
    nt = torch.full((), float(n), device=x.device)
    for _ in range(iters):
        p = torch.sigmoid(_mm(xb, w))
        g = _mm(xb.T, p - y) / nt + l2 * w
        s = p * (1.0 - p)
        H = _mm(xb.T, xb * s[:, None]) / nt + l2 * eye
        w = w - torch.linalg.solve(H, g)
    return LinearModel(w=w[:d], b=w[d])


def logistic_predict_proba(model: LinearModel, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(_mm(x, model.w) + model.b)


# ---------------------------------------------------------------- MLP ---

class MLPModel(NamedTuple):
    weights: tuple  # tuple of [in, out] matrices
    biases: tuple  # tuple of [out] vectors


def _mlp_forward(params: MLPModel, x: torch.Tensor) -> torch.Tensor:
    h = x
    n_layers = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = _mm(h, w) + b
        if i < n_layers - 1:
            h = torch.tanh(h)  # the reference's symmetric sigmoid
    return h


def mlp_init_draws(gen: torch.Generator | None, sizes: tuple[int, ...]) -> list[torch.Tensor]:
    """Standard normal draws [in, out] of each layer's initial weights,
    on the generator's device."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return [torch.randn((i, o), generator=gen, device=gen.device)
            for i, o in zip(sizes[:-1], sizes[1:])]


def train_mlp(gen: torch.Generator | None, x: torch.Tensor, y: torch.Tensor,
              hidden: tuple[int, ...] = (16,), n_classes: int = 2, iters: int = 300,
              eta0: float = 0.05, eta_up: float = 1.2, eta_down: float = 0.5,
              eta_max: float = 5.0, eta_min: float = 1e-6, init=None) -> MLPModel:
    """Multilayer perceptron trained with full-batch RPROP- (the reference
    ANN_MLP's default trainer, ml/src/ann_mlp.cpp; tanh activations,
    softmax cross-entropy readout). Initial weights are N(0, 1) * sqrt(2 /
    fan_in): the normal draws come from `init` (one [in, out] array a
    layer, e.g. JAX's) or from `gen`."""
    sizes = (x.shape[1],) + tuple(hidden) + (n_classes,)
    if init is None:
        init = mlp_init_draws(gen, sizes)
    dev = x.device
    ws = [torch.as_tensor(z, dtype=torch.float32).to(dev)
          * torch.sqrt(torch.tensor(2.0 / i, dtype=torch.float32)).to(dev)
          for z, i in zip(init, sizes[:-1])]
    params = ws + [torch.zeros(o, device=dev) for o in sizes[1:]]
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).float()
    etas = [torch.full_like(p, eta0) for p in params]
    prev = [torch.zeros_like(p) for p in params]
    nl = len(ws)
    for _ in range(iters):
        ps = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            logits = _mlp_forward(MLPModel(tuple(ps[:nl]), tuple(ps[nl:])), x)
            loss = -torch.mean(torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1))
            grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            for j, (p, g) in enumerate(zip(params, grads)):
                gp = g * prev[j]
                same, flip = gp > 0, gp < 0
                eta = torch.where(same, etas[j] * eta_up,
                                  torch.where(flip, etas[j] * eta_down, etas[j]))
                eta = torch.clamp(eta, eta_min, eta_max)
                g_eff = torch.where(flip, torch.zeros_like(g), g)  # RPROP- sign hold
                params[j] = p - torch.sign(g_eff) * eta
                etas[j], prev[j] = eta, g_eff
    return MLPModel(tuple(params[:nl]), tuple(params[nl:]))


def mlp_predict_proba(model: MLPModel, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(_mlp_forward(model, x), dim=-1)


# --------------------------------------------------------- kernel SVM ---

class KernelSVM(NamedTuple):
    alpha: torch.Tensor  # [N] dual coefficients (already * y)
    sv_x: torch.Tensor  # [N, F] training points
    kind: str  # "rbf" | "poly" | "linear"
    gamma: float
    degree: int
    coef0: float


def _kernel(kind, x1, x2, gamma, degree, coef0):
    if kind == "rbf":
        d2 = (torch.sum(x1 * x1, -1)[:, None] - 2.0 * _mm(x1, x2.T)
              + torch.sum(x2 * x2, -1)[None, :])
        return torch.exp(-gamma * torch.clamp(d2, min=0.0))
    if kind == "poly":
        return (gamma * _mm(x1, x2.T) + coef0) ** degree
    return _mm(x1, x2.T)


def train_kernel_svm(x: torch.Tensor, y: torch.Tensor, c: float = 1.0, kind: str = "rbf",
                     gamma: float | None = None, degree: int = 3, coef0: float = 1.0,
                     iters: int = 300) -> KernelSVM:
    """C-SVC with RBF/poly/linear kernels (SVM::train analog,
    ml/src/svm.cpp), as the JAX package solves it: the bias absorbed into
    the kernel (K + 1), projected gradient ascent on the box-constrained
    dual over the full Gram matrix. y in {0, 1}."""
    n, f = x.shape
    ys = 2.0 * y.float() - 1.0
    if gamma is None:
        var = torch.var(x, unbiased=False)
        gamma = float(1.0 / (f * torch.clamp(var, min=1e-12)))
    K = _kernel(kind, x, x, gamma, degree, coef0) + 1.0  # bias absorbed
    Q = K * (ys[:, None] * ys[None, :])
    step = 1.0 / torch.clamp(torch.max(torch.sum(torch.abs(Q), dim=1)), min=1e-9)
    a = torch.zeros(n, device=x.device)
    for _ in range(iters):
        a = torch.clamp(a + step * (1.0 - _mm(Q, a)), 0.0, c)
    return KernelSVM(alpha=a * ys, sv_x=x, kind=kind, gamma=float(gamma),
                     degree=degree, coef0=coef0)


def kernel_svm_decision(model: KernelSVM, x: torch.Tensor) -> torch.Tensor:
    """Signed decision values [M] (positive -> class 1)."""
    K = _kernel(model.kind, x, model.sv_x, model.gamma, model.degree, model.coef0) + 1.0
    return _mm(K, model.alpha)


# -------------------------------------------------------- naive Bayes ---

class GaussianNB(NamedTuple):
    mean: torch.Tensor  # [C, F]
    var: torch.Tensor  # [C, F]
    log_prior: torch.Tensor  # [C]


def train_naive_bayes(x: torch.Tensor, y: torch.Tensor, n_classes: int = 2) -> GaussianNB:
    """Gaussian naive Bayes (NormalBayesClassifier analog,
    ml/src/nbayes.cpp): per-class feature means and variances by one-hot
    products."""
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).float()  # [N, C]
    cnt = torch.clamp(onehot.sum(dim=0), min=1.0)
    mean = _mm(onehot.T, x) / cnt[:, None]
    ex2 = _mm(onehot.T, x * x) / cnt[:, None]
    var = torch.clamp(ex2 - mean * mean, min=1e-6)
    return GaussianNB(mean=mean, var=var, log_prior=torch.log(cnt / cnt.sum()))


def naive_bayes_predict_log_proba(model: GaussianNB, x: torch.Tensor) -> torch.Tensor:
    d = x[:, None, :] - model.mean[None]  # [N, C, F]
    ll = -0.5 * torch.sum(d * d / model.var[None] + torch.log(2 * math.pi * model.var)[None], -1)
    logp = ll + model.log_prior[None]
    return logp - torch.logsumexp(logp, dim=1, keepdim=True)


# ----------------------------------------------------------------- SVMSGD


class SVMSGDModel(NamedTuple):
    weights: torch.Tensor  # [D]
    shift: torch.Tensor  # scalar: the decision is w.x + shift


def svmsgd_indices(gen: torch.Generator | None, n: int, iters: int) -> torch.Tensor:
    """The `iters` sample indices of SVMSGD's loop, uniform over [0, n),
    on the generator's device."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return torch.randint(0, n, (iters,), generator=gen, device=gen.device)


def train_svmsgd(x: torch.Tensor, y: torch.Tensor, svmsgd_type: str = "asgd",
                 margin_type: str = "soft", margin_regularization: float = 1e-5,
                 initial_step_size: float = 0.05, step_decreasing_power: float = 0.75,
                 iters: int = 100_000, seed: int = 0, gen: torch.Generator | None = None,
                 indices=None) -> SVMSGDModel:
    """cv::ml::SVMSGD analog (reference: ml/src/svmsgd.cpp:60), as the JAX
    package has it: samples centred, scaled by 1/mean(|x|) and extended
    by a homogeneous 1 (makeExtendedTrainSamples, :173); per step one
    sample (its index from `indices`, e.g. JAX's, or drawn from `gen`, by
    default a CPU generator seeded with `seed`; the draws are the port's,
    not JAX's),
    weight decay off the margin and a hinge step on it (updateWeights,
    :184), the step 1/(1 + lambda step0 t)^power (:289) and the ASGD
    running average (:295); SOFT_MARGIN's shift from the homogeneous
    coordinate, HARD_MARGIN's from the class-wise minimal margins
    (calcShift, :203). The JAX `lax.scan` is a Python loop here, replayed
    from CUDA graphs of SGD_GRAPH_STEPS steps on the card."""
    x = x.float()
    n, d = x.shape
    dev = x.device
    pos = y >= 0
    resp = torch.where(pos, 1.0, -1.0).float()
    average = x.mean(dim=0)
    xc = x - average
    multiplier = 1.0 / (torch.abs(xc).mean() + 1e-12)
    ext = torch.cat([xc * multiplier, torch.ones((n, 1), device=dev)], dim=1)
    if indices is None:
        indices = svmsgd_indices(gen if gen is not None else torch.Generator().manual_seed(seed),
                                 n, iters)
    idx = torch.as_tensor(indices, dtype=torch.int64).to(dev)
    lam = torch.tensor(margin_regularization, dtype=torch.float32)
    step0 = torch.tensor(initial_step_size, dtype=torch.float32)
    t = torch.arange(iters, dtype=torch.float32)
    step = step0 * (1.0 + lam * step0 * t) ** (-torch.tensor(step_decreasing_power))
    # every step's sample (sign-flipped by its label: r = +-1, so s*r and
    # step*r are exact) and scalars, made once: step*lam, step, the decay
    # 1 - step*lam, t/(1+t) and 1+t
    per_step = [ext[idx] * resp[idx][:, None]] + [
        a.to(dev) for a in (step * lam, step, 1.0 - step * lam, t / (1.0 + t), 1.0 + t)]
    w = torch.zeros(d + 1, device=dev)
    w_avg = torch.zeros(d + 1, device=dev)
    done = 0
    if dev.type == "cuda" and iters >= 2 * SGD_GRAPH_STEPS:
        done = iters - iters % SGD_GRAPH_STEPS
        w, w_avg = _sgd_steps_graphed(w, w_avg, [a[:done] for a in per_step])
    w, w_avg = _sgd_steps(w, w_avg, *(a[done:].unbind(0) for a in per_step))
    ext_w = w_avg if svmsgd_type == "asgd" else w
    weights = ext_w[:d] * multiplier
    if margin_type == "soft":
        shift = ext_w[d] - torch.dot(weights, average)
    else:
        dots = _mm(x, weights)
        inf = torch.full_like(dots, float("inf"))
        m_pos = torch.where(pos, dots, inf).min()
        m_neg = torch.where(pos, inf, -dots).min()
        shift = -(m_pos - m_neg) / 2.0
    return SVMSGDModel(weights=weights, shift=shift)


SGD_GRAPH_STEPS = 1000  # SVMSGD steps one CUDA graph replays on the card


def _sgd_steps(w, w_avg, rows, sl, steps, decay, keep, den):
    """SVMSGD's steps over the given per-step samples and scalars, in
    order: a hinge step on the margin, weight decay off it, then the ASGD
    running average. About eleven small launches a step."""
    for sr, a, st, dec, k, dn in zip(rows, sl, steps, decay, keep, den):
        on_margin = torch.dot(sr, w) <= 1.0
        w = torch.where(on_margin, w - a * w + st * sr, w * dec)
        w_avg = k * w_avg + w / dn
    return w, w_avg


def _sgd_steps_graphed(w, w_avg, per_step):
    """`_sgd_steps` over [G * SGD_GRAPH_STEPS] steps as G replays of one
    CUDA graph of SGD_GRAPH_STEPS steps (the same kernels as the eager
    loop, without its per-launch host cost): each replay reads its chunk
    from static buffers and carries the weights in static tensors."""
    bufs = [a[:SGD_GRAPH_STEPS].clone() for a in per_step]
    views = [b.unbind(0) for b in bufs]
    state = [w.clone(), w_avg.clone()]

    def body():
        new_w, new_avg = _sgd_steps(state[0], state[1], *views)
        state[0].copy_(new_w)
        state[1].copy_(new_avg)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up before capture, then the state is reset
        body()
    torch.cuda.current_stream().wait_stream(side)
    state[0].copy_(w)
    state[1].copy_(w_avg)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for c in range(0, per_step[0].shape[0], SGD_GRAPH_STEPS):
        for b, a in zip(bufs, per_step):
            b.copy_(a[c:c + SGD_GRAPH_STEPS])
        graph.replay()
    return state[0].clone(), state[1].clone()


def svmsgd_decision(model: SVMSGDModel, x: torch.Tensor) -> torch.Tensor:
    """Signed decision value f(x) = w.x + shift (svmsgd.cpp predict)."""
    return _mm(x.float(), model.weights) + model.shift


def svmsgd_predict(model: SVMSGDModel, x: torch.Tensor) -> torch.Tensor:
    """Class labels in {-1, +1} (sign of the decision value)."""
    d = svmsgd_decision(model, x)
    return torch.where(d > 0, 1.0, -1.0)
