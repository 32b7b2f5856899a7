"""Morphology and the stitching package of the PyTorch port against the JAX
package on the CPU.

Tolerances.
- erode, dilate, open, close, gradient, the hats and median_blur: min,
  max, sorts and one subtraction: bit-equal (odd and even windows,
  explicit structuring elements).
- bilateral_filter: the same terms in the same order, but `exp` may
  differ from XLA's by an ulp: within 1e-4 grey levels.
- warp_cylindrical / warp_spherical: f32 tan, sin and cos may differ
  from XLA's by an ulp, which moves a sample by ~1e-5 px: within 1e-2
  grey levels.
- distance_weight: erosions and integer adds: bit-equal. feather_blend:
  the same weights and sums: within 1e-4; multiband_blend (pyramid
  arithmetic) within 1e-4 grey levels.
- gain_compensate / block_gain_compensate: the overlap sums are matmuls
  and the gains a batched solve, both ordered by the library: gains
  within 1e-5 relative, images within 1e-3 grey levels. The block
  compensator's upsampler against `jax.image.resize(..., "bilinear")`
  directly: within 1e-6. timelapse is host numpy: equal.
- dp_seam and seam_masks: f32 adds and comparisons: equal.
- stitch_pair at 120x160: ORB and matching are bit-equal to JAX
  (tests/test_torch_orb.py, test_torch_knn.py); fed the subsets that
  `PRNGKey(seed)` draws, the homography agrees to 1e-3 relative and the
  composite to 0.05 grey levels of the JAX pipeline's warp and feather
  blend under that homography. The whole JAX `stitch_pair` (eager ORB:
  ~60 s) is the `slow` test.
- estimate_panorama's stages on tests/test_global_stitch.py's 140x180
  views: the pair homographies with JAX's subsets within 1e-3 relative;
  the focal within 1e-3 relative; the tree equal; the propagated
  rotations within 1e-4 (the port's rotation projection is its own
  algorithm); the ray BA from the same pair points within 1e-3 rad and
  1e-3 relative focal. The whole pipelines against JAX are `slow`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.core.config import RansacConfig as JRansacConfig
from opencv_tpu.geometry import homography as jhom
from opencv_tpu.geometry import ransac as jransac
from opencv_tpu.geometry.rotation import rodrigues as jrodrigues
from opencv_tpu.ops import morphology as jmorph
from opencv_tpu.stitching import blend as jblend
from opencv_tpu.stitching import exposure as jexp
from opencv_tpu.stitching import global_stitch as jgs
from opencv_tpu.stitching import stitcher as jstitch
from opencv_tpu.stitching import warpers as jwarp
from opencv_tpu_torch.core.config import MatchConfig, ORBConfig
from opencv_tpu_torch.ops import matching, morphology, orb
from opencv_tpu_torch.stitching import blend, exposure, global_stitch as gs, stitcher, warpers

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _texture(rng, h, w, blur=True):
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    return np.asarray(jimg.gaussian_blur(jnp.asarray(img), 5, 1.2)) if blur else img


# ------------------------------------------------------------ morphology ---

CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
ASYM = np.array([[1, 1, 0], [0, 1, 1]], bool)  # even height, off-centre


@pytest.mark.parametrize("ksize", [3, 4, 5, (3, 4), (2, 5)])
@pytest.mark.parametrize("op", ["erode", "dilate", "morphology_open", "morphology_close",
                                "morphology_gradient", "top_hat", "black_hat"])
def test_morphology_equals_jax(rng, op, ksize):
    img = _texture(rng, 37, 52, blur=False)
    got = getattr(morphology, op)(_t(img), ksize)
    want = getattr(jmorph, op)(jnp.asarray(img), ksize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel", [CROSS, ASYM], ids=["cross", "asymmetric"])
@pytest.mark.parametrize("op", ["erode", "dilate"])
def test_explicit_kernel_equals_jax(rng, op, kernel):
    img = _texture(rng, 30, 41, blur=False)
    got = getattr(morphology, op)(_t(img), kernel=kernel)
    want = getattr(jmorph, op)(jnp.asarray(img), kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_blur_equals_jax(rng, ksize):
    img = _texture(rng, 33, 47, blur=False)
    np.testing.assert_array_equal(morphology.median_blur(_t(img), ksize).numpy(),
                                  np.asarray(jmorph.median_blur(jnp.asarray(img), ksize)))


def test_bilateral_close_to_jax(rng):
    img = _texture(rng, 32, 40)
    got = morphology.bilateral_filter(_t(img), 5, 25.0, 2.0).numpy()
    want = np.asarray(jmorph.bilateral_filter(jnp.asarray(img), 5, 25.0, 2.0))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ------------------------------------------------------------- warpers ---

@pytest.mark.parametrize("kind", ["cylindrical", "spherical"])
@pytest.mark.parametrize("out", [None, (120, 70)], ids=["same", "resized"])
def test_warps_close_to_jax(rng, kind, out):
    img = _texture(rng, 64, 96)
    ow, oh = out if out else (None, None)
    got = getattr(warpers, f"warp_{kind}")(_t(img), 150.0, ow, oh).numpy()
    want = np.asarray(getattr(jwarp, f"warp_{kind}")(jnp.asarray(img), 150.0, ow, oh))
    assert got.shape == want.shape
    assert ((got == 0) == (want == 0)).mean() > 0.999
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


# -------------------------------------------------------------- blending ---

def _masks(h=40, w=60):
    ma = np.zeros((h, w), bool)
    mb = np.zeros((h, w), bool)
    ma[:, :35] = True
    mb[3:, 25:] = True
    return ma, mb


def test_distance_weight_equals_jax():
    ma, _ = _masks()
    ma[10:14, 5:9] = False  # a hole
    for iters in (8, 64):
        np.testing.assert_array_equal(blend.distance_weight(_t(ma), iters).numpy(),
                                      np.asarray(jblend.distance_weight(jnp.asarray(ma), iters)))


def test_feather_and_multiband_close_to_jax(rng):
    ma, mb = _masks()
    a, b = _texture(rng, 40, 60), _texture(rng, 40, 60) + 30.0
    got = blend.feather_blend([_t(a), _t(b)], [_t(ma), _t(mb)]).numpy()
    want = np.asarray(jblend.feather_blend([jnp.asarray(a), jnp.asarray(b)],
                                           [jnp.asarray(ma), jnp.asarray(mb)]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for bands in (2, 3):
        got = blend.multiband_blend([_t(a), _t(b)], [_t(ma), _t(mb)], bands).numpy()
        want = np.asarray(jblend.multiband_blend([jnp.asarray(a), jnp.asarray(b)],
                                                 [jnp.asarray(ma), jnp.asarray(mb)], bands))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# -------------------------------------------------------------- exposure ---

def _canvas_triple(rng):
    """Three overlapping tiles on a 70 x 200 canvas, the second and third
    over- and under-exposed."""
    h, w = 70, 200
    tex = rng.uniform(60, 160, (h, w)).astype(np.float32)
    imgs, masks = [], []
    for (x0, x1), g in (((0, 90), 1.0), ((55, 150), 1.4), ((120, 200), 0.8)):
        c = np.zeros((h, w), np.float32)
        m = np.zeros((h, w), bool)
        c[:, x0:x1] = tex[:, x0:x1] * g
        m[:, x0:x1] = True
        imgs.append(c)
        masks.append(m)
    return imgs, masks


def test_gain_compensate_close_to_jax(rng):
    imgs, masks = _canvas_triple(rng)
    out, gains = exposure.gain_compensate([_t(i) for i in imgs], [_t(m) for m in masks])
    jout, jgains = jexp.gain_compensate(imgs, masks)
    np.testing.assert_allclose(gains.numpy(), np.asarray(jgains), rtol=1e-5)
    for o, jo in zip(out, jout):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-3, rtol=0)


def test_block_gain_compensate_close_to_jax(rng):
    imgs, masks = _canvas_triple(rng)
    out, gmap = exposure.block_gain_compensate([_t(i) for i in imgs], [_t(m) for m in masks],
                                               block=16)
    jout, jgmap = jexp.block_gain_compensate(imgs, masks, block=16)
    np.testing.assert_allclose(gmap.numpy(), np.asarray(jgmap), atol=1e-5, rtol=1e-5)
    for o, jo in zip(out, jout):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-3, rtol=0)


@pytest.mark.parametrize("shape,out", [((3, 5, 7), (3, 160, 224)), ((2, 3, 3), (2, 96, 96)),
                                       ((1, 4, 9), (1, 4, 288)), ((2, 1, 6), (2, 32, 192))])
def test_resize_linear_equals_jax_image_resize(rng, shape, out):
    x = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    got = exposure._resize_linear(_t(x), out[1], out[2]).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method="bilinear"))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_timelapse_equals_jax(rng):
    imgs, masks = _canvas_triple(rng)
    masks[2][:10] = False
    for crop in (False, True):
        got = exposure.timelapse([_t(i) for i in imgs], [_t(m) for m in masks], crop=crop)
        want = jexp.timelapse(imgs, masks, crop=crop)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- seams ---

def test_dp_seam_and_seam_masks_equal_jax(rng):
    cost = rng.uniform(0, 10, (45, 30)).astype(np.float32)
    cost[:, 12] = 0.0
    cost[10:20, 3] = -1.0
    cost[5, :] = 4.0  # ties
    np.testing.assert_array_equal(gs.dp_seam(_t(cost)).numpy(),
                                  np.asarray(jgs.dp_seam(jnp.asarray(cost))))
    ma, mb = _masks(45, 60)
    a, b = _texture(rng, 45, 60), _texture(rng, 45, 60)
    got = gs.seam_masks(_t(a), _t(ma), _t(b), _t(mb))
    want = jgs.seam_masks(jnp.asarray(a), jnp.asarray(ma), jnp.asarray(b), jnp.asarray(mb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------- stitch_pair ---

def _pair_scene():
    rng = np.random.default_rng(1234)
    scene = _texture(rng, 120, 200)
    return scene, scene[:, :160], scene[:, 40:]  # 120 px of overlap


def _pair_subsets(img0, img1, seed, n_features):
    """The subsets JAX's stitch_pair draws: `PRNGKey(seed)` over the
    matches' validity (the port's matches equal JAX's)."""
    cfg = ORBConfig(n_features=n_features, n_levels=4)
    kp0, d0 = orb.detect_and_compute(_t(img0), cfg)
    kp1, d1 = orb.detect_and_compute(_t(img1), cfg)
    m = matching.knn_match(d0, d1, kp0.valid, kp1.valid, MatchConfig())
    valid = m.valid.numpy()
    sub = jransac._sample_subsets(jax.random.PRNGKey(seed), valid.shape[0], jnp.asarray(valid),
                                  1024, 4)
    x1 = kp1.xy[m.train_idx].numpy()
    x0 = kp0.xy[m.query_idx].numpy()
    return torch.from_numpy(np.asarray(sub)).long(), x1, x0, valid


@pytest.fixture(scope="module")
def pair_case():
    scene, img0, img1 = _pair_scene()
    subsets, x1, x0, valid = _pair_subsets(img0, img1, 0, 400)
    res = jhom.find_homography_ransac(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x0),
                                      jnp.asarray(valid), JRansacConfig(1024, 3.0))
    return scene, img0, img1, subsets, np.asarray(res.model, np.float64)


def _jax_compose(img0, img1, H10):
    """The composition half of JAX's stitch_pair under a given homography."""
    h0, w0 = img0.shape
    h1, w1 = img1.shape
    corners = np.array([[0, 0, 1], [w1, 0, 1], [0, h1, 1], [w1, h1, 1]], np.float64).T
    wc = H10 @ corners
    wc = wc[:2] / wc[2]
    x_min, y_min = min(0.0, wc[0].min()), min(0.0, wc[1].min())
    out_w = int(np.ceil(max(float(w0), wc[0].max()) - x_min))
    out_h = int(np.ceil(max(float(h0), wc[1].max()) - y_min))
    T = np.array([[1, 0, -x_min], [0, 1, -y_min], [0, 0, 1]], np.float64)
    M0 = jnp.asarray(np.linalg.inv(T), jnp.float32)
    M1 = jnp.asarray(np.linalg.inv(T @ H10), jnp.float32)
    j0, j1 = jnp.asarray(img0), jnp.asarray(img1)
    w0i = jimg.warp_perspective(j0, M0, out_h, out_w)
    w1i = jimg.warp_perspective(j1, M1, out_h, out_w)
    m0 = jimg.warp_perspective(jnp.ones_like(j0), M0, out_h, out_w) > 0.5
    m1 = jimg.warp_perspective(jnp.ones_like(j1), M1, out_h, out_w) > 0.5
    return np.asarray(jblend.feather_blend([w0i, w1i], [m0, m1]))


def test_stitch_pair_homography_close_to_jax(pair_case):
    scene, img0, img1, subsets, H_jax = pair_case
    gen = torch.Generator()
    H, res = stitcher.pair_homography(_t(img0), _t(img1), 400, gen, subsets)
    np.testing.assert_allclose(H, H_jax, rtol=1e-3, atol=1e-3 * np.abs(H_jax).max())
    assert int(res.n_inliers) >= 100  # of the 122 valid matches


def test_stitch_pair_close_to_jax_pipeline(pair_case):
    scene, img0, img1, subsets, H_jax = pair_case
    got = stitcher.stitch_pair(img0, img1, n_features=400, subsets=subsets, device="cpu")
    want = _jax_compose(img0, img1, H_jax)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


@pytest.mark.slow
def test_stitch_pair_whole_close_to_jax(pair_case):
    scene, img0, img1, subsets, _ = pair_case
    got = stitcher.stitch_pair(img0, img1, n_features=400, subsets=subsets, device="cpu")
    want = jstitch.stitch_pair(img0, img1, n_features=400)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


# ------------------------------------------------------ global stitching ---

F_TRUE, H_IMG, W_IMG = 180.0, 140, 180


def _views(yaws, seed=0):
    """tests/test_global_stitch.py's pure-rotation views of a textured
    plane."""
    rng = np.random.default_rng(seed)
    ts = 640
    tex = rng.uniform(40, 215, (ts // 8, ts // 8)).astype(np.float32)
    tex = np.asarray(jimg.resize_bilinear(jnp.asarray(tex), ts, ts))
    span = 1.6
    S = np.array([[ts / (2 * span), 0, ts / 2], [0, ts / (2 * span), ts / 2], [0, 0, 1]])
    K = np.array([[F_TRUE, 0, W_IMG / 2], [0, F_TRUE, H_IMG / 2], [0, 0, 1]])
    views, Rs = [], []
    for yaw in yaws:
        R = np.asarray(jrodrigues(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
        M = S @ np.linalg.inv(K @ R)
        views.append(np.asarray(jimg.warp_perspective(jnp.asarray(tex), jnp.asarray(M, jnp.float32),
                                                      H_IMG, W_IMG)))
        Rs.append(R)
    return views, np.stack(Rs)


def pano_subsets(views, n_features, seed):
    """The subsets JAX's estimate_panorama draws: `PRNGKey(seed)` split once
    per pair with >= 8 matches, in pair order (the port's matches equal
    JAX's). Also returns each such pair's (i, j, xi, xj, valid)."""
    cfg = ORBConfig(n_features=n_features, n_levels=4)
    feats = [orb.detect_and_compute(_t(v), cfg) for v in views]
    key = jax.random.PRNGKey(seed)
    subsets, pairs = [], []
    for i in range(len(views)):
        for j in range(i + 1, len(views)):
            m = matching.knn_match(feats[i][1], feats[j][1], feats[i][0].valid, feats[j][0].valid,
                                   MatchConfig())
            valid = m.valid.numpy()
            if valid.sum() < 8:
                continue
            key, sub = jax.random.split(key)
            subsets.append(torch.from_numpy(np.asarray(jransac._sample_subsets(
                sub, valid.shape[0], jnp.asarray(valid), 512, 4))).long())
            pairs.append((i, j, sub, feats[i][0].xy[m.query_idx].numpy(),
                          feats[j][0].xy[m.train_idx].numpy(), valid))
    return subsets, pairs


@pytest.fixture(scope="module")
def pano_case():
    views, Rs = _views([-0.35, 0.0, 0.35])
    subsets, pairs = pano_subsets(views, 600, 1)
    R, f, diag = gs.estimate_panorama(views, n_features=600, seed=1, subsets=subsets, device="cpu")
    return views, Rs, subsets, pairs, R, f, diag


def _centred(H, hw_i, hw_j):
    (hi, wi), (hj, wj) = hw_i, hw_j
    Ti = np.array([[1, 0, -wi / 2.0], [0, 1, -hi / 2.0], [0, 0, 1]])
    Tj = np.array([[1, 0, -wj / 2.0], [0, 1, -hj / 2.0], [0, 0, 1]])
    Hc = Tj @ H @ np.linalg.inv(Ti)
    return Hc / Hc[2, 2]


def test_pano_stages_close_to_jax(pano_case):
    """Pair homographies with JAX's subsets, the focal, the tree and the
    propagated rotations; the ray BA from the same pair points."""
    views, Rs, subsets, pairs, R, f, diag = pano_case
    shape = (H_IMG, W_IMG)
    jhoms, jconfs = {}, []
    for i, j, sub, xi, xj, valid in pairs:
        res = jhom.find_homography_ransac(sub, jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(valid),
                                          JRansacConfig(512, 3.0))
        conf = int(res.n_inliers) / (8.0 + 0.3 * int(valid.sum()))
        if conf >= 1.0 and bool(res.ok):  # estimate_panorama's filter
            jhoms[(i, j)] = _centred(np.asarray(res.model, np.float64), shape, shape)
            jconfs.append(conf)
    assert diag["edges"] == list(jhoms) and diag["conf"] == jconfs and len(jhoms) >= 2
    for e, Hc in diag["homographies"].items():
        np.testing.assert_allclose(Hc, jhoms[e], rtol=1e-3, atol=1e-4)

    f_port = gs.estimate_focal(diag["homographies"], [shape] * 3)
    f_jax = jgs.estimate_focal(jhoms, [shape] * 3)
    assert abs(f_port - f_jax) / f_jax < 1e-3
    tree = gs.max_spanning_tree(3, diag["edges"], diag["conf"])
    assert tree == jgs.max_spanning_tree(3, diag["edges"], diag["conf"]) == diag["tree"]
    R0 = gs.propagate_rotations(3, diag["homographies"], tree, f_port)
    R0_jax = jgs.propagate_rotations(3, diag["homographies"], tree, f_port)
    np.testing.assert_allclose(R0, R0_jax, atol=1e-4)

    Rb, fb = gs.refine_rotations_ba(R0_jax, f_port, diag["pair_pts"], iters=20, device="cpu")
    Rb_jax, fb_jax = jgs.refine_rotations_ba(R0_jax, f_port, diag["pair_pts"], iters=20)
    np.testing.assert_allclose(Rb, Rb_jax, atol=1e-3)
    assert abs(fb - fb_jax) / fb_jax < 1e-3
    # the geometry: tests/test_global_stitch.py's bounds
    assert abs(f - F_TRUE) / F_TRUE < 0.12
    for k in (1, 2):
        err = (R[k] @ R[0].T) @ (Rs[k] @ Rs[0].T).T
        assert np.degrees(np.arccos(np.clip((np.trace(err) - 1) / 2, -1, 1))) < 3.0


@pytest.mark.slow
def test_estimate_and_stitch_panorama_close_to_jax(pano_case):
    views, Rs, subsets, pairs, R, f, diag = pano_case
    R_jax, f_jax, diag_jax = jgs.estimate_panorama(views, n_features=600, seed=1)
    assert diag["edges"] == diag_jax["edges"] and diag["tree"] == diag_jax["tree"]
    assert abs(f - f_jax) / f_jax < 1e-3
    np.testing.assert_allclose(R, R_jax, atol=1e-3)
    pano = gs.compose_panorama([_t(v) for v in views], R_jax, f_jax, blend_bands=2)
    want = jgs.stitch_panorama(views, n_features=600, seed=1, blend_bands=2)
    assert pano.shape == want.shape
    assert (np.abs(pano.numpy() - want) < 0.05).mean() > 0.999
