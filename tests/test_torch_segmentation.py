"""Graph cuts, GrabCut, watershed and CamShift of the PyTorch port against
the JAX package on the CPU.

Tolerances.
- min_cut_grid: push-relabel on equal capacities is f32 subtractions,
  additions, minima and comparisons in the same order: labels equal, for
  4 and 8 neighbours, converged and stopped at a small `max_sweeps`; the
  sweep count equals the JAX loop's (`_jax_sweeps` replays its
  `while_loop` with a counter). seam_find_graphcut: equal masks.
- grab_cut: beta, the k-means and GMM moments are large sums and the
  3x3 inverses and log-determinants library calls, all ordered
  differently, so the capacities differ by ulps: >= 99.9 % of the mask
  equal to jitted JAX's (measured: 100 % on these scenes).
- watershed: minima, maxima and comparisons: labels and dams equal.
- calc_hist / calc_back_project: integer counts: equal.
  _moment_integrals: XLA's prefix-sum order: bit-equal.
- mean_shift: the same f32 step arithmetic on equal sums: iteration
  counts and windows equal. cam_shift: the moments are equal, numpy's
  f32 trig may differ from XLA's by an ulp: boxes within 1e-3, windows
  equal. track_window_sequence: windows equal, boxes within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from opencv_tpu.ops import camshift as jcs
from opencv_tpu.ops import grabcut as jgc
from opencv_tpu.ops import graphcut as jgr
from opencv_tpu.ops import watershed as jws
from opencv_tpu_torch.ops import camshift as tcs
from opencv_tpu_torch.ops import grabcut as tgc
from opencv_tpu_torch.ops import graphcut as tgr
from opencv_tpu_torch.ops import watershed as tws

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- min-cut ---

def _cut_problem(rng, h, w, k):
    """Random unary terms with a bright disc preferring the source, and
    symmetric pairwise capacities toward the K directions."""
    yy, xx = np.mgrid[0:h, 0:w]
    disc = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (min(h, w) / 3) ** 2
    src = (rng.uniform(0, 4, (h, w)) + 6 * disc).astype(np.float32)
    snk = (rng.uniform(0, 4, (h, w)) + 6 * ~disc).astype(np.float32)
    base = rng.uniform(0.5, 3.0, (k // 2, h, w)).astype(np.float32)
    dirs = tgr._DIRS8[:k]
    caps = np.zeros((k, h, w), np.float32)
    for d in range(0, k, 2):  # d and d+1 are opposite: share the edge weight
        dy, dx = dirs[d]
        caps[d] = base[d // 2]
        # the opposite slot of the neighbour holds the same edge
        caps[d + 1] = np.roll(base[d // 2], (dy, dx), axis=(0, 1))
    return src, snk, caps


def _jax_sweeps(src, snk, caps, max_sweeps):
    """The JAX solver's push-relabel loop, with a counter: the number of
    sweeps its `while_loop` runs (graphcut.py's body, verbatim)."""
    h, w = src.shape
    n = h * w + 2
    dirs = jgr._DIRS8[:caps.shape[0]]
    opp = [k ^ 1 for k in range(len(dirs))]

    def active(e, ht):
        return (e > 0) & (ht < n)

    def body(carry):
        i, e, ht, res, _ = carry
        for k, (dy, dx) in enumerate(dirs):
            nb = jgr._shift(ht, dy, dx, n)
            can = active(e, ht) & (ht == nb + 1) & (res[k] > 0)
            amt = jnp.where(can, jnp.minimum(e, res[k]), 0.0)
            e = e - amt
            res = res.at[k].add(-amt)
            arrived = jgr._shift(amt, -dy, -dx, 0.0)
            e = e + arrived
            res = res.at[opp[k]].add(arrived)
        min_h = jnp.full((h, w), n, jnp.int32)
        for k, (dy, dx) in enumerate(dirs):
            nb = jgr._shift(ht, dy, dx, n)
            min_h = jnp.where(res[k] > 0, jnp.minimum(min_h, nb + 1), min_h)
        new = jnp.where(active(e, ht), jnp.maximum(ht, min_h), ht)
        return i + 1, e, new, res, ~jnp.any(active(e, new))

    init = (jnp.int32(0), jnp.asarray(src - snk), jnp.zeros((h, w), jnp.int32), jnp.asarray(caps),
            jnp.bool_(False))
    out = lax.while_loop(lambda c: (c[0] < max_sweeps) & ~c[4], body, init)
    return int(out[0])


@pytest.mark.parametrize("k,max_sweeps", [(4, 4096), (8, 4096), (4, 5), (8, 7)])
def test_min_cut_labels_equal_jax(rng, k, max_sweeps):
    src, snk, caps = _cut_problem(rng, 24, 31, k)
    got = tgr.min_cut_grid_stats(_t(src), _t(snk), _t(caps), max_sweeps)
    want = jgr.min_cut_grid(jnp.asarray(src), jnp.asarray(snk), jnp.asarray(caps), max_sweeps)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want))
    assert got.sweeps == _jax_sweeps(src, snk, caps, max_sweeps)
    assert got.capped == (max_sweeps < 100)
    if not got.capped:
        assert 0.2 < got.labels.numpy().mean() < 0.8  # the disc


def test_seam_find_graphcut_equals_jax(rng):
    h, w = 30, 50
    a = rng.uniform(0, 255, (h, w)).astype(np.float32)
    b = a + rng.normal(0, 3, (h, w)).astype(np.float32)
    b[:, 28] += 80.0  # a column where the images disagree
    m0 = np.zeros((h, w), bool)
    m1 = np.zeros((h, w), bool)
    m0[:, :35] = True
    m1[:, 20:] = True
    got = tgr.seam_find_graphcut(_t(a), _t(m0), _t(b), _t(m1))
    want = jgr.seam_find_graphcut(jnp.asarray(a), jnp.asarray(m0), jnp.asarray(b), jnp.asarray(m1))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


# ------------------------------------------------------------- grabcut ---

def _grabcut_scene(h=70, w=90, seed=0):
    """examples/segmentation_demo.py's scene: a red-ish blob on green."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 1] = 120
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((xx - w / 2) ** 2 / (400 * (w / 90) ** 2) + (yy - h / 2) ** 2 / (250 * (h / 70) ** 2)) < 1
    img[blob] = [40, 40, 200]
    img += rng.normal(0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255), blob


@pytest.fixture(scope="module")
def grabcut_jax():
    img, blob = _grabcut_scene()
    rect = (18, 10, 58, 52)
    run = jax.jit(functools.partial(jgc.grab_cut, rect=rect, iter_count=4))
    return img, blob, rect, np.asarray(run(jnp.asarray(img)))


def test_grab_cut_close_to_jax(grabcut_jax):
    img, blob, rect, want = grabcut_jax
    got = tgc.grab_cut_stats(img, rect=rect, iter_count=4, device="cpu")
    mask = got.mask.numpy()
    assert (mask == want).mean() >= 0.999
    fg = mask % 2 == 1
    assert (fg & blob).sum() / (fg | blob).sum() > 0.8  # the demo's IoU bound
    # 6 300 pixels with trapped excess: each cut runs to the 4096-sweep cap
    # (the JAX solver too: its labels equal the port's at the cap)
    assert got.sweeps == [4096] * 4 and all(got.capped)


def test_grab_cut_hard_labels_and_stages(rng):
    """A mask with hard labels; the N-link capacities and beta against the
    JAX functions."""
    img, _ = _grabcut_scene(30, 40, seed=3)
    mask = np.full((30, 40), tgc.GC_PR_BGD, np.int32)
    mask[8:22, 10:30] = tgc.GC_PR_FGD
    mask[13:17, 18:22] = tgc.GC_FGD
    mask[:3] = tgc.GC_BGD
    got = tgc.grab_cut(img, mask=mask, iter_count=1, device="cpu").numpy()
    want = np.asarray(jgc.grab_cut(jnp.asarray(img), mask=jnp.asarray(mask), iter_count=1))
    assert (got == want).mean() >= 0.999
    assert (got[13:17, 18:22] == tgc.GC_FGD).all() and (got[:3] == tgc.GC_BGD).all()
    chw = np.ascontiguousarray(img.transpose(2, 0, 1))
    beta = tgc._calc_beta(_t(chw))
    jbeta = jgc._calc_beta(jnp.asarray(chw))
    np.testing.assert_allclose(float(beta), float(jbeta), rtol=1e-5)
    np.testing.assert_allclose(tgc._n_weights(_t(chw), beta).numpy(),
                               np.asarray(jgc._n_weights(jnp.asarray(chw), jbeta)), rtol=1e-4,
                               atol=1e-6)
    x = _t(img.reshape(-1, 3))
    w = _t((mask.reshape(-1) % 2 == 1).astype(np.float32))
    np.testing.assert_array_equal(tgc._kmeans(x, w, 5).numpy(),
                                  np.asarray(jgc._kmeans(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), 5)))


# ----------------------------------------------------------- watershed ---

def _two_basins(h=70, w=90):
    xx = np.mgrid[0:h, 0:w][1]
    surface = (100 - 80 * np.exp(-((xx - 25) ** 2) / 200)
               - 80 * np.exp(-((xx - 65) ** 2) / 200)).astype(np.float32)
    markers = np.zeros((h, w), np.int32)
    markers[30:34, 20:28] = 1
    markers[30:34, 60:68] = 2
    return surface, markers


def test_watershed_equals_jax(rng):
    surface, markers = _two_basins()
    got = tws.watershed_stats(surface, markers, device="cpu")
    want = np.asarray(jws.watershed(jnp.asarray(surface), markers))
    np.testing.assert_array_equal(got.labels.numpy(), want)
    assert (want == -1).any() and got.sweeps > 16 and got.host_reads == -(-got.sweeps // 16)
    # colour image, three seeds, a cap that stops the relaxation early
    img = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
    m = np.zeros((30, 40), np.int32)
    m[5, 5], m[20, 30], m[25, 8] = 1, 2, 3
    for cap in (4096, 9):
        np.testing.assert_array_equal(
            tws.watershed(img, m, cap, device="cpu").numpy(),
            np.asarray(jws.watershed(jnp.asarray(img), m, cap)))


# ------------------------------------------------------------ camshift ---

def _blob_frame(cx, cy, rng, h=120, w=160, r=14):
    """examples/segmentation_demo.py's frame: a bright disc on noise."""
    f = rng.uniform(20, 60, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.where((xx - cx) ** 2 + (yy - cy) ** 2 < r * r, 210.0, f).astype(np.float32)


def test_histograms_equal_jax(rng):
    a = np.floor(rng.uniform(0, 256, (40, 50))).astype(np.float32)
    b = np.floor(rng.uniform(-10, 190, (40, 50))).astype(np.float32)
    mask = rng.random((40, 50)) > 0.3
    for chans, bins, ranges in (([a], [32], [(0, 256)]), ([a, b], [16, 12], [(0, 256), (0, 180)])):
        for m in (None, mask):
            for density in (False, True):
                got = tcs.calc_hist([_t(c) for c in chans], bins, ranges,
                                    None if m is None else _t(m), density)
                want = jcs.calc_hist([jnp.asarray(c) for c in chans], bins, ranges,
                                     None if m is None else jnp.asarray(m), density)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        bp = tcs.calc_back_project([_t(c) for c in chans], got, ranges, 2.0)
        jbp = jcs.calc_back_project([jnp.asarray(c) for c in chans], want, ranges, 2.0)
        np.testing.assert_array_equal(bp.numpy(), np.asarray(jbp))


def test_moment_integrals_equal_jax(rng):
    prob = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    for order2 in (False, True):
        np.testing.assert_array_equal(tcs._moment_integrals(_t(prob), order2).numpy(),
                                      np.asarray(jcs._moment_integrals(jnp.asarray(prob), order2)))


def _camshift_cases(rng):
    frame = _blob_frame(90, 60, rng)
    prob = (frame > 100).astype(np.float32) * 200.0 + rng.uniform(0, 5, frame.shape).astype(np.float32)
    return prob, [((70, 40, 30, 30), 100, 1.0), ((5, 5, 40, 40), 100, 1.0),
                  ((100, 80, 50, 50), 3, 1.0), ((60, 45, 30, 30), 100, 0.0),
                  ((150, 110, 30, 30), 100, 1.0)]


def test_mean_shift_and_cam_shift_equal_jax(rng):
    prob, cases = _camshift_cases(rng)
    for window, max_iter, eps in cases:
        i, win = tcs.mean_shift(_t(prob), window, max_iter, eps)
        ji, jwin = jcs.mean_shift(jnp.asarray(prob), window, max_iter, eps)
        assert (i, win) == (int(ji), tuple(int(v) for v in jwin))
        (c, size, ang), nwin = tcs.cam_shift(_t(prob), window, max_iter, eps)
        (jc, jsize, jang), jnwin = jcs.cam_shift(jnp.asarray(prob), window, max_iter, eps)
        assert nwin == tuple(int(v) for v in jnwin)
        np.testing.assert_allclose([*c, *size, ang], [float(v) for v in (*jc, *jsize, jang)],
                                   atol=1e-3, rtol=1e-5)


def test_track_window_sequence_equals_jax():
    """examples/segmentation_demo.py's CamShift track: 7 frames of a
    moving blob."""
    rng = np.random.default_rng(0)
    centers = [(40 + 9 * t, 50 + 4 * t) for t in range(7)]
    frames = [_blob_frame(cx, cy, rng) for cx, cy in centers]
    win = (25, 35, 30, 30)
    tmpl = frames[0][win[1]:win[1] + win[3], win[0]:win[0] + win[2]]
    hist = tcs.calc_hist([_t(tmpl)], [32], [(0, 256)], density=True) * 255.0
    jhist = jcs.calc_hist([jnp.asarray(tmpl)], [32], [(0, 256)], density=True) * 255.0
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    got = tcs.track_window_sequence([[f] for f in frames[1:]], hist, [(0, 256)], win, device="cpu")
    want = jcs.track_window_sequence([[jnp.asarray(f)] for f in frames[1:]], jhist, [(0, 256)], win)
    for (box, w), (jbox, jw) in zip(got, want):
        assert w == jw
        (c, size, ang), (jc, jsize, jang) = box, jbox
        np.testing.assert_allclose([*c, *size, ang], [float(v) for v in (*jc, *jsize, jang)],
                                   atol=1e-3, rtol=1e-5)
    errs = [np.hypot(b[0][0] - c[0], b[0][1] - c[1]) for (b, _), c in zip(got, centers[1:])]
    assert np.mean(errs) < 6  # the demo's bound
