"""MOG2, KNN, GMG and FGD background subtraction of the PyTorch port
against the JAX package on the CPU.

Tolerance: none. Each model runs the JAX functions' elementwise f32
arithmetic in their order (MOG2's cumulative weights in XLA's prefix-sum
order, every division by a tensor); KNN takes JAX's own slot and uniform
draws. Over a sequence of frames, and for one frame from a mid-sequence
JAX state carried across by `convert.background_state`, the foreground
masks and the states are asserted equal.

MOG2 ranks its components by fitness with a stable sort, as
`jnp.argsort`. `test_mog2_fitness_tie_takes_the_stable_order` builds a
tie that straddles the background ratio and runs the port with a sort
that reverses ties wherever `stable=True` is not asked for (torch's CPU
sort happens to keep small ties in order, so an unstable call would not
show here otherwise; the card's need not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ops import bgsegm as J
from opencv_tpu_torch import convert
from opencv_tpu_torch.ops import bgsegm as T

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"
H, W = 48, 64


def _frames(rng, n=40):
    """A textured static background with N(0, 2) noise and a bright box
    crossing it; frames 25-29 also dim a band (a lighting change)."""
    bg = rng.uniform(40, 200, (H, W)).astype(np.float32)
    out = []
    for t in range(n):
        f = bg + rng.normal(0, 2, (H, W))
        x = t % (W - 12)
        f[10:22, x:x + 12] = 250.0
        if 25 <= t < 30:
            f[30:40] *= 0.8
        out.append(np.round(f).astype(np.float32))
    return out


def _state_equal(js, ts):
    for f, a, b in zip(js._fields, js, ts):
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
        else:
            assert b == int(a), f


def _knn_draws(key, s):
    k1, k2 = jax.random.split(key)
    slot = np.asarray(jax.random.randint(k1, (H, W), 0, s))
    u = np.asarray(jax.random.uniform(k2, (H, W)))
    return torch.from_numpy(slot).long(), torch.from_numpy(u)


def _run(rng, model, n=40):
    """Run JAX and the port side by side; returns (fg counts, the JAX
    states after frame 20, the frames)."""
    frames = _frames(rng, n)
    f0 = frames[0]
    if model == "mog2":
        cfg = J.MOG2Config(n_mixtures=4)
        js, ts = J.init_state(jnp.asarray(f0), cfg), T.init_state(f0, T.MOG2Config(n_mixtures=4),
                                                                   device=CPU)
    elif model == "knn":
        js, ts = J.knn_init(jnp.asarray(f0), 8), T.knn_init(f0, 8, device=CPU)
    elif model == "gmg":
        js, ts = J.gmg_init(H, W), T.gmg_init(H, W, device=CPU)
    else:
        js, ts = J.fgd_init(jnp.asarray(f0)), T.fgd_init(f0, device=CPU)
    key = jax.random.PRNGKey(3)
    counts, mid = [], None
    for t, f in enumerate(frames):
        if model == "mog2":
            js, jm = J.apply(js, jnp.asarray(f), cfg, learning_rate=0.05)
            ts, tm = T.apply(ts, f, T.MOG2Config(n_mixtures=4), learning_rate=0.05)
        elif model == "knn":
            key, sub = jax.random.split(key)
            slot, u = _knn_draws(sub, 8)
            js, jm = J.knn_apply(js, jnp.asarray(f), sub)
            ts, tm = T.knn_apply(ts, f, slot=slot, uniform=u)
        elif model == "gmg":
            js, jm = J.gmg_apply(js, jnp.asarray(f), n_init_frames=10)
            ts, tm = T.gmg_apply(ts, f, n_init_frames=10)
        else:
            js, jm = J.fgd_apply(js, jnp.asarray(f))
            ts, tm = T.fgd_apply(ts, f)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm), err_msg=f"{model} frame {t}")
        counts.append(int(tm.sum()))
        if t == 20:
            mid = js
    _state_equal(js, ts)
    return counts, mid, frames


@pytest.mark.parametrize("model", ["mog2", "knn", "gmg", "fgd"])
def test_sequence_equals_jax(rng, model):
    counts, _, _ = _run(rng, model)
    assert max(counts[12:]) > 50  # the box is found
    if model == "gmg":
        assert max(counts[:10]) == 0  # training frames


@pytest.mark.parametrize("model", ["mog2", "knn", "gmg", "fgd"])
def test_one_frame_from_a_carried_state_equals_jax(rng, model):
    _, mid, frames = _run(rng, model, n=22)
    ts = convert.background_state(mid, device=CPU)
    assert type(ts).__name__ == type(mid).__name__
    _state_equal(mid, ts)
    f = frames[-1] + 3.0
    if model == "mog2":
        cfg = J.MOG2Config(n_mixtures=4)
        (js, jm), (ts, tm) = J.apply(mid, jnp.asarray(f), cfg), T.apply(ts, f, T.MOG2Config(4))
    elif model == "knn":
        key = jax.random.PRNGKey(11)
        slot, u = _knn_draws(key, 8)
        (js, jm), (ts, tm) = J.knn_apply(mid, jnp.asarray(f), key), T.knn_apply(ts, f, slot=slot,
                                                                                uniform=u)
    elif model == "gmg":
        (js, jm), (ts, tm) = J.gmg_apply(mid, jnp.asarray(f), 10), T.gmg_apply(ts, f, 10)
    else:
        (js, jm), (ts, tm) = J.fgd_apply(mid, jnp.asarray(f)), T.fgd_apply(ts, f)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _state_equal(js, ts)


def test_background_state_rejects_other_records():
    with pytest.raises(KeyError):
        convert.background_state(J.MOG2Config(), device=CPU)


def test_knn_draws_from_a_generator():
    f = np.full((8, 8), 100.0, np.float32)
    st = T.knn_init(f, 4, device=CPU)
    with pytest.raises(ValueError):
        T.knn_apply(st, f)
    outs = [T.knn_apply(st, f + 5.0, torch.Generator().manual_seed(1), update_prob=0.5)[0].samples
            for _ in range(2)]
    assert torch.equal(*outs) and not torch.equal(outs[0], st.samples)


def _tie_reversing_argsort(real):
    """argsort that keeps equal keys in order only when asked to be stable,
    and otherwise reverses them (an order an unstable sort may choose)."""
    def argsort(x, dim=-1, descending=False, stable=False):
        if stable:
            return real(x, dim=dim, descending=descending, stable=True)
        n = x.shape[dim]
        return n - 1 - real(x.flip(dim), dim=dim, descending=descending, stable=True).flip(dim)
    return argsort


def test_mog2_fitness_tie_takes_the_stable_order(monkeypatch):
    """Components 1 and 2 tie in fitness (weight 0.09, variance 15);
    component 0 holds 0.82. In JAX's stable order component 1 ranks
    before 2, so the cumulative weight before 2 is 0.91 >= 0.9: a pixel
    that fits only component 2 is foreground, one that fits only
    component 1 background. With learning rate 0 the update keeps the
    tie."""
    k, h, w = 3, 2, 3
    weights = np.zeros((k, h, w), np.float32)
    weights[0], weights[1], weights[2] = 0.82, 0.09, 0.09
    means = np.zeros((k, h, w), np.float32)
    means[0], means[1], means[2] = 100.0, 150.0, 200.0
    var = np.full((k, h, w), 15.0, np.float32)
    frame = np.array([[200, 150, 100], [200, 150, 120]], np.float32)
    cfg = J.MOG2Config(n_mixtures=3)
    js, jm = J.apply(J.MOG2State(*map(jnp.asarray, (weights, means, var))), jnp.asarray(frame), cfg,
                     learning_rate=0.0)
    np.testing.assert_array_equal(np.asarray(jm), [[True, False, False], [True, False, True]])
    monkeypatch.setattr(torch, "argsort", _tie_reversing_argsort(torch.argsort))
    ts, tm = T.apply(convert.background_state(J.MOG2State(weights, means, var), device=CPU), frame,
                     T.MOG2Config(n_mixtures=3), learning_rate=0.0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _state_equal(js, ts)
