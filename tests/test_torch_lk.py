"""Pyramidal LK of the PyTorch port (ops/lk.py, the LK pyramid and the
Scharr/Sobel derivatives) against the JAX package on the CPU.

Bit for bit where eager JAX is exact: the derivatives, pyrDown/pyrUp and
the LK pyramid (the same tap order in `sep_filter2d`), the interpolation
weights, the dense sampler in f32 and in bf16, and the patch gather. The
template sums of G run in another order than XLA's: asserted at rtol 1e-5
and 1e-6 of the sums' scale.
Tracked points (also of the pairs form, on the same stacked pyramids) are
held to JAX at 0.05 px on points that pass the gate:
JAX runs its step loops compiled, where XLA fuses multiply-adds, so the
two packages' iterations part in the last bits and may stop one step
apart within the 0.01 px eps (measured: <= 2e-5 px after the polish).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_tpu.ops.pallas.lk_sample as jls
from opencv_tpu.core import imgproc as jimg
from opencv_tpu.core import pyramid as jpyr
from opencv_tpu.core.config import LKConfig as JLKConfig
from opencv_tpu.ops import lk as jlk
from opencv_tpu_torch.core import imgproc as timg
from opencv_tpu_torch.core import pyramid as tpyr
from opencv_tpu_torch.core.config import LKConfig
from opencv_tpu_torch.ops import lk as tlk

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def _textured(rng, h=120, w=160):
    """The blocky, slightly blurred texture of tests/test_lk.py."""
    img = rng.uniform(0, 255, size=(h // 4, w // 4)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))
    return np.asarray(jimg.gaussian_blur(jnp.asarray(img), 5, 1.2))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


IMAGE_OPS = {
    "scharr": (jimg.scharr_derivatives, timg.scharr_derivatives),
    "sobel3": (lambda x: jimg.sobel_derivatives(x, 3), lambda x: timg.sobel_derivatives(x, 3)),
    "sobel5": (lambda x: jimg.sobel_derivatives(x, 5), lambda x: timg.sobel_derivatives(x, 5)),
    "pyr_down": (lambda x: (jpyr.pyr_down(x),), lambda x: (tpyr.pyr_down(x),)),
    "pyr_up": (lambda x: (jpyr.pyr_up(x),), lambda x: (tpyr.pyr_up(x),)),
    "lk_pyramid": (lambda x: jpyr.build_lk_pyramid(x, 4).levels,
                   lambda x: tpyr.build_lk_pyramid(x, 4).levels),
}


@pytest.mark.parametrize("op", sorted(IMAGE_OPS))
def test_image_ops_bit_equal_to_eager_jax(rng, op):
    img = rng.uniform(0, 255, (61, 83)).astype(np.float32)
    jf, tf = IMAGE_OPS[op]
    got, want = tf(_t(img)), jf(jnp.asarray(img))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_flow_pyramid_bit_equal(rng):
    img = _textured(rng)
    got = tlk.build_flow_pyramid(img, LKConfig(n_levels=3), device="cpu")
    want = jlk.build_flow_pyramid(jnp.asarray(img), JLKConfig(n_levels=3))
    for g_lvl, w_lvl in zip(got, want):
        for g, w in zip(g_lvl, w_lvl):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_weights_and_dense_sampler_bit_equal(rng, wdtype):
    """`_interp_weights` and the dense sampler (a gather of the einsum's
    two taps) equal the XLA einsum exactly, also where windows hang off
    the image; in bf16 every product is exact in f32."""
    img = _textured(rng)
    pts = np.stack([rng.uniform(-8, 168, 64), rng.uniform(-8, 128, 64)], -1).astype(np.float32)
    jd, td = getattr(jnp, wdtype), getattr(torch, wdtype)
    np.testing.assert_array_equal(
        tlk._interp_weights(_t(pts[:, 1]), 21, 120, td).to(torch.float32).numpy(),
        np.asarray(jlk._interp_weights(jnp.asarray(pts[:, 1]), 21, 120, jd)).astype(np.float32))
    got = tlk._sample_at(_t(img)[None], _t(pts), 21, td)[0].to(torch.float32).numpy()
    want = np.asarray(jlk._sample_at(jnp.asarray(img), jnp.asarray(pts), 21, jlk._PS, jd))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_extract_patches_exact(rng):
    img = _textured(rng)
    y0 = np.array([0, 10, 72, 33], np.int32)
    x0 = np.array([0, 112, 50, 7], np.int32)
    bf = jnp.asarray(img).astype(jnp.bfloat16)[None]
    want = np.asarray(jlk._extract_patches(bf, jnp.asarray(y0), jnp.asarray(x0), 48))
    got = tlk._extract_patches(_t(img).to(torch.bfloat16)[None], _t(y0), _t(x0), 48)
    np.testing.assert_array_equal(got.numpy(), want)


def _tpu_rule(monkeypatch):
    """JAX with the TPU branch of its sampler switch, the Pallas kernel in
    interpret mode (as tests/test_pallas_lk_sample.py:188-210 runs it)."""
    monkeypatch.setattr(jlk, "_use_pallas_templates",
                        lambda h, w, win: win <= 23 and h * w >= 90_000)
    orig = jls.sample_channels_pallas
    monkeypatch.setattr(jls, "sample_channels_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("kernel", [False, True])
def test_level_templates(rng, monkeypatch, kernel):
    """Templates, G and the gate, sampled densely or by K4's plain version
    (the port's gate forced either way on this small level)."""
    monkeypatch.setattr(tlk, "_use_sampler_kernel", lambda h, w, win: kernel)
    img = _textured(rng)
    dx, dy = jimg.scharr_derivatives(jnp.asarray(img))
    pts = np.stack([rng.uniform(0, 159, 64), rng.uniform(0, 119, 64)], -1).astype(np.float32)
    jt = jlk._level_templates(jnp.asarray(img), dx, dy, jnp.asarray(pts), JLKConfig(),
                              use_pallas=kernel, _pallas_interpret=True)
    tt = tlk._level_templates(_t(img), _t(dx), _t(dy), _t(pts), LKConfig())
    np.testing.assert_array_equal(tt.ok.numpy(), np.asarray(jt.ok))
    for name in ("iw", "ix", "iy"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                   rtol=1e-5, atol=1e-3)
    # sums of 441 products in another order: off by ulps of the terms'
    # scale, which gxy and min_eig can cancel far below
    scale = float(np.abs(np.asarray(jt.gxx)).max() + np.abs(np.asarray(jt.gyy)).max())
    for name, atol in (("gxx", 1e-6 * scale), ("gxy", 1e-6 * scale), ("gyy", 1e-6 * scale),
                       ("min_eig", 1e-6 * scale / 441)):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                   rtol=1e-5, atol=atol)


@pytest.fixture(scope="module")
def big_level():
    """A 304x304 level (over the 90 000-px gate of the patch path and of
    the kernel) and a smooth warp of it: translation plus a slight shear."""
    rng = np.random.default_rng(21)
    h = w = 304
    base = rng.normal(0, 50.0, (h, w)).astype(np.float32) + 100.0
    img0 = np.asarray(jimg.gaussian_blur(jnp.asarray(base), 9, 2.0))
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    map_xy = np.stack([xx - 2.3 - 0.01 * yy, yy + 1.7], axis=-1)
    img1 = np.asarray(jimg.remap(jnp.asarray(img0), jnp.asarray(map_xy)))
    pts = np.stack([rng.uniform(30, w - 30, 40), rng.uniform(30, h - 30, 40)], -1)
    pts = pts.astype(np.float32)
    pts[:4] = [[2.0, 3.0], [w - 2.0, 100.0], [150.0, h - 1.0], [-1.0, 50.0]]
    dx, dy = (np.asarray(a) for a in jimg.scharr_derivatives(jnp.asarray(img0)))
    t = tlk._track_level_patch(_t(img0), _t(img1), _t(dx), _t(dy), _t(pts), _t(pts),
                               LKConfig(win_size=21, n_levels=1))
    return img0, img1, dx, dy, pts, t


@pytest.mark.parametrize("jax_branch", ["tpu_kernel", "cpu_einsum"])
def test_track_level_patch(big_level, monkeypatch, jax_branch):
    """The port's patch-cached level (K4's plain version at its three sites)
    against JAX's TPU branch (Pallas in interpret mode) and its CPU branch
    (XLA einsums)."""
    img0, img1, dx, dy, pts, (g_t, me_t, _) = big_level
    if jax_branch == "tpu_kernel":
        _tpu_rule(monkeypatch)
    g_j, me_j, _ = jlk._track_level_patch(_j(img0), _j(img1), _j(dx), _j(dy), _j(pts), _j(pts),
                                          JLKConfig(win_size=21, n_levels=1))
    ok = np.asarray(me_j) > 1e-4
    assert ok.sum() >= 36
    np.testing.assert_array_equal(me_t.numpy() > 1e-4, ok)
    np.testing.assert_allclose(me_t.numpy(), np.asarray(me_j), rtol=1e-4)
    np.testing.assert_allclose(g_t.numpy()[ok], np.asarray(g_j)[ok], rtol=0, atol=0.05)
    moved = g_t.numpy()[4:] - pts[4:]
    assert np.median(moved[:, 0]) > 2.0 and np.median(moved[:, 1]) < -1.0


def test_track_level_dense(rng):
    img = _textured(rng)
    moved = np.roll(img, (1, 2), axis=(0, 1))
    pts = np.stack([rng.uniform(20, 140, 40), rng.uniform(20, 100, 40)], -1).astype(np.float32)
    dx, dy = jimg.scharr_derivatives(jnp.asarray(img))
    cfg = JLKConfig(win_size=21, n_levels=1)
    g_j, me_j, r_j = jlk._track_level_dense(_j(img), _j(moved), dx, dy, _j(pts), _j(pts), cfg)
    g_t, me_t, r_t = tlk._track_level_dense(_t(img), _t(moved), _t(dx), _t(dy), _t(pts), _t(pts),
                                            LKConfig(win_size=21, n_levels=1))
    ok = np.asarray(me_j) > cfg.min_eig_threshold
    assert ok.sum() >= 30
    np.testing.assert_allclose(g_t.numpy()[ok], np.asarray(g_j)[ok], atol=0.05)
    np.testing.assert_allclose(g_t.numpy()[ok], pts[ok] + [2.0, 1.0], atol=0.05)


def _both(img0, img1, pts, valid=None, cfg=None):
    cfg = cfg or LKConfig()
    jv = None if valid is None else jnp.asarray(valid)
    j = jlk.calc_optical_flow_pyr_lk(_j(img0), _j(img1), _j(pts), jv,
                                     JLKConfig(**cfg.__dict__))
    t = tlk.calc_optical_flow_pyr_lk(img0, img1, pts, valid, cfg, device="cpu")
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def test_lk_pure_translation(rng):
    img = _textured(rng)
    moved = np.roll(img, (3, 5), axis=(0, 1))
    pts = np.array([[40.0, 30.0], [80.0, 60.0], [120.0, 50.0], [60.0, 90.0]], np.float32)
    (jn, js, _), (tn, ts, terr) = _both(img, moved, pts)
    assert ts.all() and js.all()
    np.testing.assert_allclose(tn, jn, atol=0.05)
    np.testing.assert_allclose(tn - pts, np.tile([5.0, 3.0], (4, 1)), atol=0.35)
    assert terr.shape == (4,) and np.isfinite(terr).all()


def test_lk_large_motion_needs_pyramid(rng):
    img = _textured(rng)
    moved = np.roll(img, (0, 18), axis=(0, 1))
    pts = np.array([[60.0, 60.0], [90.0, 40.0]], np.float32)
    (jn, js, _), (tn, ts, _) = _both(img, moved, pts, cfg=LKConfig(n_levels=4))
    assert ts.all() and js.all()
    np.testing.assert_allclose(tn, jn, atol=0.05)
    np.testing.assert_allclose(tn[:, 0] - pts[:, 0], 18.0, atol=0.6)


def test_lk_flat_region_rejected():
    img = np.full((100, 100), 50.0, np.float32)
    img[10:20, 10:20] = 200.0
    (_, js, _), (_, ts, _) = _both(img, img, np.array([[70.0, 70.0]], np.float32))
    assert not ts[0] and not js[0]


def test_lk_identity_and_invalid_points(rng):
    img = _textured(rng)
    pts = np.array([[50.0, 50.0], [30.0, 80.0], [60.0, 60.0]], np.float32)
    valid = np.array([True, True, False])
    (jn, js, je), (tn, ts, te) = _both(img, img, pts, valid)
    np.testing.assert_array_equal(ts, [True, True, False])
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tn[:2], pts[:2], atol=0.05)
    assert te[:2].max() < 1.0


def _pairs_case(rng, shape):
    """A 4-frame clip moving (2, 1) px per frame, its stacked pyramids
    (win 11, 2 levels) and 32 points per pair, ~10 % invalid."""
    h, w = shape
    cfg = LKConfig(win_size=11, n_levels=2)
    base = _textured(rng, h, w)
    frames = np.stack([np.roll(base, (i, 2 * i), axis=(0, 1)) for i in range(4)])
    pts = np.stack([np.stack([rng.uniform(20, w - 20, 32), rng.uniform(20, h - 20, 32)], -1)
                    for _ in range(3)]).astype(np.float32)
    valid = rng.random((3, 32)) > 0.1
    return frames, pts, valid, cfg, tlk.build_flow_pyramid(frames, cfg, device="cpu")


@pytest.mark.parametrize("shape", [(120, 160), (304, 320)])
def test_pairs_match_sequential(rng, shape):
    """Every pair of a clip at once (`_pairs`) against the pyramid-reuse
    chain pair by pair: the same samplers, so bit for bit at both sizes
    (304x320's level 0 takes the patch path and K4's sites)."""
    frames, pts, valid, cfg, stacked = _pairs_case(rng, shape)
    new_b, st_b, err_b = tlk.calc_optical_flow_pyr_lk_pairs(stacked, pts, valid, cfg)
    assert new_b.shape == (3, 32, 2) and st_b.shape == err_b.shape == (3, 32)
    pyrs = [tlk.build_flow_pyramid(f, cfg, device="cpu") for f in frames]
    for i in range(3):
        new_s, st_s, err_s = tlk.calc_optical_flow_pyr_lk_pyr(pyrs[i], pyrs[i + 1], pts[i],
                                                              valid[i], cfg)
        np.testing.assert_array_equal(st_b[i].numpy(), st_s.numpy())
        np.testing.assert_array_equal(new_b[i].numpy(), new_s.numpy())
        np.testing.assert_array_equal(err_b[i].numpy(), err_s.numpy())
        st = st_s.numpy()
        flow = new_s.numpy()[st] - pts[i][st]
        np.testing.assert_allclose(flow, np.broadcast_to([2.0, 1.0], flow.shape), atol=0.1)


@pytest.mark.parametrize("shape", [(120, 160), (304, 320)])
def test_pairs_match_jax(rng, shape):
    """The port's `_pairs` against JAX's on the same stacked pyramids: the
    same status, tracked points within 0.05 px."""
    _, pts, valid, cfg, stacked = _pairs_case(rng, shape)
    new_t, st_t, _ = tlk.calc_optical_flow_pyr_lk_pairs(stacked, pts, valid, cfg)
    j_pyrs = tuple(tuple(_j(a) for a in lvl) for lvl in stacked)
    new_j, st_j, _ = jlk.calc_optical_flow_pyr_lk_pairs(j_pyrs, _j(pts), _j(valid),
                                                        JLKConfig(**cfg.__dict__))
    st = st_t.numpy()
    assert st.sum() >= 60
    np.testing.assert_array_equal(st, np.asarray(st_j))
    np.testing.assert_allclose(new_t.numpy()[st], np.asarray(new_j)[st], rtol=0, atol=0.05)


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlk.calc_optical_flow_pyr_lk(img, img, np.zeros((1, 2), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlk.build_flow_pyramid(img)
    pyr = tlk.build_flow_pyramid(img, device="cpu")
    assert pyr[0][0].device.type == "cpu"
